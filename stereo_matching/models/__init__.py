"""Model families: stereo matchers sharing the cost-volume front end.

The reference implements exactly one aggregation (guided filter,
guidedFilter.cu); its commented-out remains sketch a plain box-mean
aggregation (winner_take_all.cuh, filter.cu — dead code, SURVEY.md
§2.4).  Here both are first-class models behind one interface:

  * GuidedStereoMatcher — the flagship: guided-filter aggregation,
    bit-exact parity mode.
  * BoxStereoMatcher — plain box-mean cost aggregation (the classic
    SAD+box baseline; BASELINE.json config #1), sharing the cost
    volume, WTA rule, LR check and occlusion fill.
"""

from .base import StereoMatcher
from .guided import GuidedStereoMatcher
from .box import BoxStereoMatcher

__all__ = ["StereoMatcher", "GuidedStereoMatcher", "BoxStereoMatcher"]
