// Native COCO mask codecs: column-major RLE decode/encode, the
// pycocotools LEB128-style compressed-counts string codec, and a scanline
// polygon rasteriser.
//
// This is the framework's native data-loader core. The reference delegates
// these to pycocotools' C extension (the reference's src/human_edge_detection/
// dataset.py:6-7,106-111); this file provides the same primitives behind a
// plain C ABI consumed via ctypes (no pybind11 needed). The Python
// wrappers in ../coco.py fall back to pure-numpy implementations when the
// shared object is unavailable.
//
// Build: g++ -O3 -shared -fPIC rle.cpp -o librle_<hash>.so (native.py, into build/native/)

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

extern "C" {

// Decode uncompressed column-major run lengths into an h*w row-major mask.
void rle_decode(const int32_t* counts, int n, uint8_t* out, int h, int w) {
  std::memset(out, 0, (size_t)h * w);
  long pos = 0;
  int val = 0;
  const long total = (long)h * w;
  for (int i = 0; i < n && pos < total; ++i) {
    long c = counts[i];
    if (c > total - pos) c = total - pos;
    if (val) {
      // column-major position p -> (row = p % h, col = p / h)
      for (long p = pos; p < pos + c; ++p) {
        out[(p % h) * (long)w + (p / h)] = 1;
      }
    }
    pos += c;
    val ^= 1;
  }
}

// Encode a row-major h*w mask to column-major run lengths.
// Returns the number of counts written (<= max_out).
int rle_encode(const uint8_t* mask, int h, int w, int32_t* out, int max_out) {
  int n = 0;
  long run = 0;
  int cur = 0;
  for (long col = 0; col < w; ++col) {
    for (long row = 0; row < h; ++row) {
      int v = mask[row * (long)w + col] ? 1 : 0;
      if (v == cur) {
        ++run;
      } else {
        if (n >= max_out) return -1;
        out[n++] = (int32_t)run;
        cur = v;
        run = 1;
      }
    }
  }
  if (n >= max_out) return -1;
  out[n++] = (int32_t)run;
  return n;
}

// pycocotools compressed-counts string -> counts. Returns count written.
int leb_decode(const uint8_t* s, int len, int32_t* out, int max_out) {
  int i = 0, n = 0;
  while (i < len) {
    long x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      if (i >= len) return -1;
      int c = s[i] - 48;
      x |= (long)(c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
      if (!more && (c & 0x10)) x |= -1L << (5 * k);
    }
    if (n > 2) x += out[n - 2];
    if (n >= max_out) return -1;
    out[n++] = (int32_t)x;
  }
  return n;
}

// counts -> compressed string. Returns bytes written.
int leb_encode(const int32_t* counts, int n, uint8_t* out, int max_out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    long x = counts[i];
    if (i > 2) x -= (long)counts[i - 2];
    bool more = true;
    while (more) {
      int c = x & 0x1f;
      x >>= 5;
      more = !((x == 0 && !(c & 0x10)) || (x == -1 && (c & 0x10)));
      if (more) c |= 0x20;
      if (m >= max_out) return -1;
      out[m++] = (uint8_t)(c + 48);
    }
  }
  return m;
}

// Even-odd scanline polygon fill (plus boundary), matching the behaviour
// the training pipeline needs (interiors exact; boundary pixels included).
// xy: flat [x0, y0, x1, y1, ...]; poly_sizes: number of (x, y) pairs per
// polygon; the union of all polygons is written into out (h*w row-major).
void rasterize_polygons(const double* xy, const int32_t* poly_sizes,
                        int n_polys, uint8_t* out, int h, int w) {
  std::memset(out, 0, (size_t)h * w);
  const double* p = xy;
  std::vector<double> xs;
  for (int pi = 0; pi < n_polys; ++pi) {
    int npts = poly_sizes[pi];
    if (npts >= 3) {
      for (int row = 0; row < h; ++row) {
        double yc = row + 0.0;  // sample at integer rows (PIL convention)
        xs.clear();
        for (int i = 0; i < npts; ++i) {
          int j = (i + 1) % npts;
          double y0 = p[2 * i + 1], y1 = p[2 * j + 1];
          double x0 = p[2 * i], x1 = p[2 * j];
          if ((y0 <= yc && y1 > yc) || (y1 <= yc && y0 > yc)) {
            xs.push_back(x0 + (yc - y0) * (x1 - x0) / (y1 - y0));
          }
        }
        std::sort(xs.begin(), xs.end());
        for (size_t k = 0; k + 1 < xs.size(); k += 2) {
          int xa = (int)std::ceil(xs[k]);
          int xb = (int)std::floor(xs[k + 1]);
          xa = std::max(xa, 0);
          xb = std::min(xb, w - 1);
          for (int x = xa; x <= xb; ++x) out[(long)row * w + x] = 1;
        }
      }
      // include the outline (PIL draws outline + fill)
      for (int i = 0; i < npts; ++i) {
        int j = (i + 1) % npts;
        double x0 = p[2 * i], y0 = p[2 * i + 1];
        double x1 = p[2 * j], y1 = p[2 * j + 1];
        int steps = (int)std::max(std::fabs(x1 - x0), std::fabs(y1 - y0)) + 1;
        for (int s = 0; s <= steps; ++s) {
          double t = (double)s / steps;
          int x = (int)std::lround(x0 + t * (x1 - x0));
          int y = (int)std::lround(y0 + t * (y1 - y0));
          if (x >= 0 && x < w && y >= 0 && y < h) out[(long)y * w + x] = 1;
        }
      }
    }
    p += 2 * npts;
  }
}

}  // extern "C"
