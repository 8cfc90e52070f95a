// Native host-side synthetic page engine: the port's own copy of
// text_segmentation_image_inpainting_tpu/data/native/pagegen.cpp, the same
// code, so the two packages draw the same pages from the same seeds.
//
// Page synthesis runs on the host beside the training step. The PIL-based path (data/text_overlay.py) costs ~12 ms/page
// at 512^2 — this engine produces the same distribution (procedural
// manga-ish page + glyph-run text overlay + exact text mask) in C++,
// reading glyph shapes from a Python-prerendered PIL atlas so the text
// statistics match the PIL path exactly.
//
// Outputs are uint8: (h, w, 3) page and (h, w) 0/1 text mask. The u8
// form is what serving ships and what the device pipeline uploads;
// float conversion (when a caller wants the classic f32 sample) happens
// once in numpy on the wrapper side.
//
// Build: make -C text_segmentation_image_inpainting_tpu_torch/data/native
// Bindings + PIL fallback: data/native_pages.py
//
// RNG: xorshift128+ (same generator as maskgen.cpp), seeded per page —
// deterministic per seed, independent of PIL/numpy RNG streams.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

namespace {

struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    auto next = [&seed]() {
      seed += 0x9E3779B97f4A7C15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      return z ^ (z >> 31);
    };
    s0 = next();
    s1 = next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
  int64_t randint(int64_t lo, int64_t hi) {  // [lo, hi)
    return lo + static_cast<int64_t>(uniform() * static_cast<double>(hi - lo));
  }
};

inline void hline(uint8_t* g, int w, int y, int x0, int x1, uint8_t c) {
  if (x0 > x1) return;
  std::memset(g + static_cast<size_t>(y) * w + x0, c, x1 - x0 + 1);
}

void fill_rect(uint8_t* g, int h, int w, int x0, int y0, int x1, int y1,
               uint8_t c) {
  x0 = std::clamp(x0, 0, w - 1);
  x1 = std::clamp(x1, 0, w - 1);
  y0 = std::clamp(y0, 0, h - 1);
  y1 = std::clamp(y1, 0, h - 1);
  for (int y = y0; y <= y1; ++y) hline(g, w, y, x0, x1, c);
}

void rect_outline(uint8_t* g, int h, int w, int x0, int y0, int x1, int y1,
                  uint8_t c, int width) {
  fill_rect(g, h, w, x0, y0, x1, y0 + width - 1, c);
  fill_rect(g, h, w, x0, y1 - width + 1, x1, y1, c);
  fill_rect(g, h, w, x0, y0, x0 + width - 1, y1, c);
  fill_rect(g, h, w, x1 - width + 1, y0, x1, y1, c);
}

inline void stamp_square(uint8_t* g, int h, int w, int cx, int cy, int r,
                         uint8_t c) {
  const int y0 = std::max(0, cy - r), y1 = std::min(h - 1, cy + r);
  const int x0 = std::max(0, cx - r), x1 = std::min(w - 1, cx + r);
  for (int y = y0; y <= y1; ++y) hline(g, w, y, x0, x1, c);
}

void draw_line(uint8_t* g, int h, int w, double x0, double y0, double x1,
               double y1, uint8_t c, int width) {
  const double dx = x1 - x0, dy = y1 - y0;
  const double len = std::max(1.0, std::hypot(dx, dy));
  const int steps = static_cast<int>(len) + 1;
  const int r = std::max(0, width / 2);
  for (int t = 0; t <= steps; ++t) {
    const double f = static_cast<double>(t) / steps;
    stamp_square(g, h, w, static_cast<int>(x0 + f * dx),
                 static_cast<int>(y0 + f * dy), r, c);
  }
}

void ellipse_outline(uint8_t* g, int h, int w, double x0, double y0, double x1,
                     double y1, uint8_t c, int width) {
  const double cx = 0.5 * (x0 + x1), cy = 0.5 * (y0 + y1);
  const double rx = std::max(1.0, 0.5 * (x1 - x0));
  const double ry = std::max(1.0, 0.5 * (y1 - y0));
  const int steps = static_cast<int>(4.0 * (rx + ry)) + 16;
  const int r = std::max(0, width / 2);
  for (int t = 0; t < steps; ++t) {
    const double a = 2.0 * M_PI * t / steps;
    stamp_square(g, h, w, static_cast<int>(cx + rx * std::cos(a)),
                 static_cast<int>(cy + ry * std::sin(a)), r, c);
  }
}

// Procedural manga-ish page, mirroring text_overlay.py::synthetic_page:
// white background, 1-3 filled panels with black borders, 5-19 random
// polylines, 2-7 ellipse outlines.
void synthetic_page_u8(Rng& rng, uint8_t* gray, int h, int w) {
  std::memset(gray, 255, static_cast<size_t>(h) * w);
  const int64_t n_panels = rng.randint(1, 4);
  for (int64_t i = 0; i < n_panels; ++i) {
    const int x0 = static_cast<int>(rng.randint(0, w / 2));
    const int y0 = static_cast<int>(rng.randint(0, h / 2));
    const int x1 = static_cast<int>(rng.randint(x0 + w / 4, w));
    const int y1 = static_cast<int>(rng.randint(y0 + h / 4, h));
    const uint8_t fill = static_cast<uint8_t>(rng.randint(140, 255));
    fill_rect(gray, h, w, x0, y0, x1, y1, fill);
    rect_outline(gray, h, w, x0, y0, x1, y1, 0, 3);
  }
  const int64_t n_lines = rng.randint(5, 20);
  for (int64_t i = 0; i < n_lines; ++i) {
    const int64_t n_pts = rng.randint(2, 5);
    const uint8_t c = static_cast<uint8_t>(rng.randint(0, 100));
    const int width = static_cast<int>(rng.randint(1, 4));
    double px = rng.uniform(0, w), py = rng.uniform(0, h);
    for (int64_t p = 1; p < n_pts; ++p) {
      const double nx = rng.uniform(0, w), ny = rng.uniform(0, h);
      draw_line(gray, h, w, px, py, nx, ny, c, width);
      px = nx;
      py = ny;
    }
  }
  const int64_t n_ell = rng.randint(2, 8);
  for (int64_t i = 0; i < n_ell; ++i) {
    const double x0 = rng.randint(0, std::max(1, w - 40));
    const double y0 = rng.randint(0, std::max(1, h - 40));
    const double x1 = x0 + rng.randint(20, std::max(21, w - static_cast<int>(x0)));
    const double y1 = y0 + rng.randint(20, std::max(21, h - static_cast<int>(y0)));
    ellipse_outline(gray, h, w, x0, y0, std::min<double>(x1, w - 1),
                    std::min<double>(y1, h - 1),
                    static_cast<uint8_t>(rng.randint(0, 120)), 2);
  }
}

// Glyph atlas layout (built by native_pages.py from the PIL default
// font): per (size_idx, char_idx) entry, meta holds
//   [offset, gw, gh, advance]  (int32)
// into a flat uint8 alpha buffer. Stamping max-blends the alpha into
// the text layer; the mask is alpha > 127, matching the PIL path.
struct Atlas {
  const uint8_t* bits;
  const int32_t* meta;  // (n_sizes * n_chars, 4)
  const int32_t* sizes;
  int n_sizes, n_chars;
};

void stamp_glyph(uint8_t* layer, int h, int w, const Atlas& a, int size_idx,
                 int char_idx, int x, int y) {
  const int32_t* m = a.meta + 4 * (static_cast<size_t>(size_idx) * a.n_chars + char_idx);
  const uint8_t* bits = a.bits + m[0];
  const int gw = m[1], gh = m[2];
  for (int gy = 0; gy < gh; ++gy) {
    const int py = y + gy;
    if (py < 0 || py >= h) continue;
    uint8_t* row = layer + static_cast<size_t>(py) * w;
    const uint8_t* src = bits + static_cast<size_t>(gy) * gw;
    const int x0 = std::max(0, -x), x1 = std::min(gw, w - x);
    for (int gx = x0; gx < x1; ++gx)
      row[x + gx] = std::max(row[x + gx], src[gx]);
  }
}

// Text overlay mirroring text_overlay.py::overlay_text: 3-9 runs of
// 1-11 random glyphs at size 12-47, vertical (manga column) with
// probability 0.4, horizontal with per-glyph advances otherwise.
void overlay_text_u8(Rng& rng, const Atlas& a, uint8_t* text_layer, int h,
                     int w, int runs_lo, int runs_hi, double vertical_prob) {
  const int64_t n_runs = rng.randint(runs_lo, runs_hi);
  for (int64_t rn = 0; rn < n_runs; ++rn) {
    const int size_idx = static_cast<int>(rng.randint(0, a.n_sizes));
    const int size = a.sizes[size_idx];
    const int64_t n_chars = rng.randint(1, 12);
    int x = static_cast<int>(rng.randint(0, std::max(1, w - size)));
    int y = static_cast<int>(rng.randint(0, std::max(1, h - size)));
    const bool vertical = rng.uniform() < vertical_prob;
    for (int64_t ci = 0; ci < n_chars; ++ci) {
      const int char_idx = static_cast<int>(rng.randint(0, a.n_chars));
      stamp_glyph(text_layer, h, w, a, size_idx, char_idx, x, y);
      if (vertical) {
        y += size;
        if (y > h - size) break;
      } else {
        x += a.meta[4 * (static_cast<size_t>(size_idx) * a.n_chars + char_idx) + 3];
        if (x > w) break;
      }
    }
  }
}

// text color distribution from text_overlay.py: {0, 0.08, 0.15, 1.0}
// with p = {0.55, 0.15, 0.1, 0.2}, quantized to u8.
uint8_t pick_text_color(Rng& rng) {
  const double u = rng.uniform();
  if (u < 0.55) return 0;
  if (u < 0.70) return 20;   // 0.08 * 255
  if (u < 0.80) return 38;   // 0.15 * 255
  return 255;
}

}  // namespace

extern "C" {

// One call = one batch of synthetic pages.
//   mode 0 ('seg'):     page WITH composited text; mask = text pixels.
//   mode 1 ('inpaint'): CLEAN page; mask = text pixels of a text layer
//                       that is rendered but NOT composited (the caller
//                       turns it into holes).
// out_img:  (batch, h, w, 3) uint8   out_mask: (batch, h, w) uint8 0/1
void synth_page_batch(
    uint8_t* out_img, uint8_t* out_mask, int batch, int h, int w, int mode,
    const uint64_t* seeds,
    const uint8_t* atlas_bits, const int32_t* atlas_meta,
    const int32_t* atlas_sizes, int n_sizes, int n_chars,
    int runs_lo, int runs_hi, double vertical_prob) {
  const size_t npix = static_cast<size_t>(h) * w;
  uint8_t* gray = new uint8_t[npix];
  uint8_t* layer = new uint8_t[npix];
  const Atlas atlas{atlas_bits, atlas_meta, atlas_sizes, n_sizes, n_chars};

  for (int b = 0; b < batch; ++b) {
    Rng rng(seeds[b]);
    synthetic_page_u8(rng, gray, h, w);
    std::memset(layer, 0, npix);
    overlay_text_u8(rng, atlas, layer, h, w, runs_lo, runs_hi, vertical_prob);
    const uint8_t color = pick_text_color(rng);

    uint8_t* img = out_img + 3 * npix * b;
    uint8_t* msk = out_mask + npix * b;
    for (size_t i = 0; i < npix; ++i) {
      const bool on = layer[i] > 127;
      msk[i] = on ? 1 : 0;
      const uint8_t v = (mode == 0 && on) ? color : gray[i];
      img[3 * i] = v;
      img[3 * i + 1] = v;
      img[3 * i + 2] = v;
    }
  }
  delete[] gray;
  delete[] layer;
}

}  // extern "C"
