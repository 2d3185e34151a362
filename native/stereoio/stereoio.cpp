// stereoio — native image I/O + output normalizer for the stereo
// framework.
//
// The reference vendors the stb single-header C codecs for its image
// layer (stb_image.h / stb_image_write.h, enabled in
// SystemIncludes.h:3-5 and driven from main.cu:57-58,162-181).  This
// is the framework's own codec, written against the PNG spec on top of
// zlib: 8- and 16-bit color types 0/2/3/4/6 (palette 8-bit only), all
// five scanline filters, non-interlaced; writes gray/RGB/RGBA with
// filter 0 (8-bit, plus 16-bit gray for disparity ground truth).
// 16-bit support matches stb_image.h's PNG16 path — needed to read
// Middlebury-style ground-truth disparity files.
//
// Also implements the reference driver's write_mat min-max normalizer
// (main.cu:13-35) bit-for-bit, including its quirky running-max/min
// scan (an element that raises the running max never updates the min)
// and the truncating (unsigned char)(int) conversion.
//
// C ABI only — loaded from Python with ctypes (utils/io.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

constexpr unsigned char kMagic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

void put_be32(unsigned char* p, uint32_t v) {
  p[0] = (v >> 24) & 0xFF;
  p[1] = (v >> 16) & 0xFF;
  p[2] = (v >> 8) & 0xFF;
  p[3] = v & 0xFF;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return (pb <= pc) ? b : c;
}

bool inflate_all(const std::vector<unsigned char>& in, std::vector<unsigned char>& out) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<unsigned char*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  const size_t chunk = 1 << 18;
  std::vector<unsigned char> buf(chunk);
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    zs.next_out = buf.data();
    zs.avail_out = static_cast<uInt>(chunk);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out.insert(out.end(), buf.data(), buf.data() + (chunk - zs.avail_out));
    if (ret != Z_STREAM_END && zs.avail_in == 0 && zs.avail_out != 0) break;
  }
  inflateEnd(&zs);
  return ret == Z_STREAM_END;
}

}  // namespace

namespace {

// May allocate (std::vector) — only called via the try/catch wrapper in
// sio_read_png so std::bad_alloc on malformed lengths cannot cross the
// extern "C"/ctypes boundary and abort the host process.
int read_png_impl(const char* path, unsigned char** data, int* out_w, int* out_h,
                  int* out_channels, int* out_depth) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  const long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, kMagic, 8) != 0) {
    fclose(f);
    return 2;
  }
  uint32_t w = 0, h = 0;
  int bitdepth = 0, color_type = -1, interlace = 0;
  std::vector<unsigned char> idat;
  std::vector<unsigned char> palette;  // rgb triples
  std::vector<unsigned char> trns;
  for (;;) {
    unsigned char hdr[8];
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t len = be32(hdr);
    // a declared chunk length can't exceed what's left of the file (nor
    // the spec's 2^31-1); reject before allocating untrusted lengths
    const long remaining = fsize - ftell(f);
    if (len > 0x7FFFFFFFu || long(len) > remaining) {
      fclose(f);
      return 3;
    }
    char type[5] = {0};
    memcpy(type, hdr + 4, 4);
    std::vector<unsigned char> chunk(len);
    if (len && fread(chunk.data(), 1, len, f) != len) {
      fclose(f);
      return 3;
    }
    fseek(f, 4, SEEK_CUR);  // skip CRC
    if (!strcmp(type, "IHDR") && len >= 13) {
      w = be32(chunk.data());
      h = be32(chunk.data() + 4);
      bitdepth = chunk[8];
      color_type = chunk[9];
      interlace = chunk[12];
    } else if (!strcmp(type, "PLTE")) {
      palette = chunk;
    } else if (!strcmp(type, "tRNS")) {
      trns = chunk;
    } else if (!strcmp(type, "IDAT")) {
      idat.insert(idat.end(), chunk.begin(), chunk.end());
    } else if (!strcmp(type, "IEND")) {
      break;
    }
  }
  fclose(f);
  if (!w || !h || interlace != 0) return 4;
  if (bitdepth != 8 && bitdepth != 16) return 4;
  if (bitdepth == 16 && color_type == 3) return 4;  // spec forbids
  if (size_t(w) * h > (size_t(1) << 31)) return 4;  // sanity vs corrupt IHDR
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;
    case 2: ch = 3; break;
    case 3: ch = 1; break;
    case 4: ch = 2; break;
    case 6: ch = 4; break;
    default: return 5;
  }
  std::vector<unsigned char> raw;
  if (!inflate_all(idat, raw)) return 6;
  const size_t bpp = size_t(ch) * (bitdepth / 8);  // filter offset, bytes
  const size_t stride = size_t(w) * bpp;
  if (raw.size() != h * (stride + 1)) return 7;

  std::vector<unsigned char> img(h * stride);
  std::vector<unsigned char> prev(stride, 0);
  for (uint32_t y = 0; y < h; ++y) {
    const unsigned char filter = raw[y * (stride + 1)];
    const unsigned char* line = raw.data() + y * (stride + 1) + 1;
    unsigned char* cur = img.data() + y * stride;
    switch (filter) {
      case 0:
        memcpy(cur, line, stride);
        break;
      case 1:  // Sub
        for (size_t x = 0; x < stride; ++x)
          cur[x] = line[x] + (x >= bpp ? cur[x - bpp] : 0);
        break;
      case 2:  // Up
        for (size_t x = 0; x < stride; ++x) cur[x] = line[x] + prev[x];
        break;
      case 3:  // Average
        for (size_t x = 0; x < stride; ++x) {
          int left = x >= bpp ? cur[x - bpp] : 0;
          cur[x] = line[x] + ((left + prev[x]) >> 1);
        }
        break;
      case 4:  // Paeth
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int c = x >= bpp ? prev[x - bpp] : 0;
          cur[x] = line[x] + paeth(a, prev[x], c);
        }
        break;
      default:
        return 8;
    }
    memcpy(prev.data(), cur, stride);
  }

  if (color_type == 3) {
    if (palette.empty()) return 9;
    const int out_ch = trns.empty() ? 3 : 4;
    unsigned char* out = static_cast<unsigned char*>(malloc(size_t(w) * h * out_ch));
    if (!out) return 10;
    for (size_t i = 0; i < size_t(w) * h; ++i) {
      const unsigned idx = img[i];
      out[i * out_ch + 0] = idx * 3 + 2 < palette.size() ? palette[idx * 3 + 0] : 0;
      out[i * out_ch + 1] = idx * 3 + 2 < palette.size() ? palette[idx * 3 + 1] : 0;
      out[i * out_ch + 2] = idx * 3 + 2 < palette.size() ? palette[idx * 3 + 2] : 0;
      if (out_ch == 4) out[i * out_ch + 3] = idx < trns.size() ? trns[idx] : 255;
    }
    *data = out;
    *out_w = int(w);
    *out_h = int(h);
    *out_channels = out_ch;
    *out_depth = 8;
    return 0;
  }

  unsigned char* out = static_cast<unsigned char*>(malloc(img.size()));
  if (!out) return 10;
  if (bitdepth == 16) {
    // PNG samples are big-endian; emit host-endian uint16
    uint16_t* o16 = reinterpret_cast<uint16_t*>(out);
    for (size_t i = 0; i < img.size() / 2; ++i)
      o16[i] = uint16_t(img[2 * i]) << 8 | img[2 * i + 1];
  } else {
    memcpy(out, img.data(), img.size());
  }
  *data = out;
  *out_w = int(w);
  *out_h = int(h);
  *out_channels = ch;
  *out_depth = bitdepth;
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success.  *data is malloc'd (h*w*channels samples; 2
// bytes each when *out_depth == 16, host-endian); free with sio_free.
// Palette images are expanded to RGB (or RGBA with tRNS).
int sio_read_png(const char* path, unsigned char** data, int* out_w, int* out_h,
                 int* out_channels, int* out_depth) {
  try {
    return read_png_impl(path, data, out_w, out_h, out_channels, out_depth);
  } catch (...) {
    return 11;  // bad_alloc / length_error on a malformed file
  }
}

// Writes magic + IHDR + IDAT + IEND with full I/O error checking: a
// short write (disk full) or failed close/flush returns nonzero
// instead of reporting a truncated file as success.
static int write_png_file(const char* path, const unsigned char ihdr[13],
                          const unsigned char* comp, size_t comp_len) {
  FILE* f = fopen(path, "wb");
  if (!f) return 3;
  bool ok = fwrite(kMagic, 1, 8, f) == 8;
  auto chunk = [&](const char* type, const unsigned char* payload, uint32_t len) {
    unsigned char hdr[8];
    put_be32(hdr, len);
    memcpy(hdr + 4, type, 4);
    ok = ok && fwrite(hdr, 1, 8, f) == 8;
    if (len) ok = ok && fwrite(payload, 1, len, f) == len;
    uLong crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, reinterpret_cast<const Bytef*>(type), 4);
    if (len) crc = crc32(crc, payload, len);
    unsigned char tail[4];
    put_be32(tail, static_cast<uint32_t>(crc));
    ok = ok && fwrite(tail, 1, 4, f) == 4;
  };
  chunk("IHDR", ihdr, 13);
  chunk("IDAT", comp, static_cast<uint32_t>(comp_len));
  chunk("IEND", nullptr, 0);
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : 5;
}

// channels: 1 (gray), 3 (RGB) or 4 (RGBA).  Filter 0, zlib level 6.
int sio_write_png(const char* path, const unsigned char* data, int w, int h,
                  int channels) {
  try {
    int color_type;
    switch (channels) {
      case 1: color_type = 0; break;
      case 3: color_type = 2; break;
      case 4: color_type = 6; break;
      default: return 1;
    }
    const size_t stride = size_t(w) * channels;
    std::vector<unsigned char> raw(size_t(h) * (stride + 1));
    for (int y = 0; y < h; ++y) {
      raw[y * (stride + 1)] = 0;
      memcpy(raw.data() + y * (stride + 1) + 1, data + y * stride, stride);
    }
    uLongf clen = compressBound(static_cast<uLong>(raw.size()));
    std::vector<unsigned char> comp(clen);
    if (compress2(comp.data(), &clen, raw.data(), static_cast<uLong>(raw.size()), 6) != Z_OK)
      return 2;

    unsigned char ihdr[13];
    put_be32(ihdr, uint32_t(w));
    put_be32(ihdr + 4, uint32_t(h));
    ihdr[8] = 8;
    ihdr[9] = static_cast<unsigned char>(color_type);
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    return write_png_file(path, ihdr, comp.data(), size_t(clen));
  } catch (...) {
    return 4;  // bad_alloc must not cross the extern "C"/ctypes boundary
  }
}

// 16-bit grayscale writer (disparity ground-truth files).  `data` is
// host-endian uint16; samples are written big-endian per the PNG spec.
int sio_write_png16(const char* path, const uint16_t* data, int w, int h) {
  try {
    const size_t stride = size_t(w) * 2;
    std::vector<unsigned char> raw(size_t(h) * (stride + 1));
    for (int y = 0; y < h; ++y) {
      unsigned char* line = raw.data() + size_t(y) * (stride + 1);
      line[0] = 0;
      for (int x = 0; x < w; ++x) {
        const uint16_t v = data[size_t(y) * w + x];
        line[1 + 2 * x] = (v >> 8) & 0xFF;
        line[2 + 2 * x] = v & 0xFF;
      }
    }
    uLongf clen = compressBound(static_cast<uLong>(raw.size()));
    std::vector<unsigned char> comp(clen);
    if (compress2(comp.data(), &clen, raw.data(), static_cast<uLong>(raw.size()), 6) != Z_OK)
      return 2;
    unsigned char ihdr[13];
    put_be32(ihdr, uint32_t(w));
    put_be32(ihdr + 4, uint32_t(h));
    ihdr[8] = 16;
    ihdr[9] = 0;  // grayscale
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    return write_png_file(path, ihdr, comp.data(), size_t(clen));
  } catch (...) {
    return 4;
  }
}

void sio_free(void* p) { free(p); }

// write_mat (main.cu:13-35), bit-for-bit: running max/min scan where an
// element that breaks the running max skips the min branch, then
// c = (int)((v - min) * 255.0f / (max - min)) truncated and wrapped
// through (unsigned char).
void sio_write_mat_normalize(const float* in, unsigned char* out, long long n) {
  float mx = -150000000.0f, mn = 150000000.0f;
  for (long long i = 0; i < n; ++i) {
    const float v = in[i];
    if (v > mx)
      mx = v;
    else if (v <= mn)
      mn = v;
  }
  const float scale_den = mx - mn;
  if (scale_den == 0.0f) {
    // constant input: the reference's expression divides by zero and
    // casts NaN to int (UB).  Both hardware paths happened to produce
    // 0; make that the defined contract (matches the NumPy twin).
    for (long long i = 0; i < n; ++i) out[i] = 0;
    return;
  }
  for (long long i = 0; i < n; ++i) {
    const int c = int((in[i] - mn) * 255.0f / scale_den);
    out[i] = static_cast<unsigned char>(c);
  }
}

}  // extern "C"
