// Native host-side mask rasterizer: the benchmark's frozen copy of
// text_segmentation_image_inpainting_tpu_torch/data/native/maskgen.cpp, the
// same code, so that the traffic does not move when the program does.
//
// Generates irregular hole masks (random-walk strokes with round brushes
// + rectangles) orders of magnitude faster than the numpy disk-stamping
// loop, so mask synthesis stays off the training step's critical path.
// Exposed to Python via ctypes (portbench/pages.py).
//
// Build: make -C portbench/native (into portbench/native/build/)
//
// RNG: xorshift128+ seeded per call — deterministic for a given seed,
// independent of libc rand.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

namespace {

struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    // splitmix64 to spread the seed
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

inline void stamp_disk(uint8_t* holes, int h, int w, double cy, double cx, int r) {
  const int y0 = std::max(0, static_cast<int>(cy) - r);
  const int y1 = std::min(h - 1, static_cast<int>(cy) + r);
  const int x0 = std::max(0, static_cast<int>(cx) - r);
  const int x1 = std::min(w - 1, static_cast<int>(cx) + r);
  const double rr = static_cast<double>(r) * r;
  for (int y = y0; y <= y1; ++y) {
    const double dy = y - cy;
    const double rem = rr - dy * dy;
    if (rem < 0) continue;
    const double dx = std::sqrt(rem);
    int xa = std::max(x0, static_cast<int>(std::ceil(cx - dx)));
    int xb = std::min(x1, static_cast<int>(std::floor(cx + dx)));
    if (xa <= xb) std::memset(holes + static_cast<size_t>(y) * w + xa, 1, xb - xa + 1);
  }
}

}  // namespace

extern "C" {

// Writes a float32 validity mask (1 = keep, 0 = hole) of shape (h, w)
// into `out`. Stroke parameters mirror data/masks.py defaults.
void random_stroke_mask(
    float* out, int h, int w, uint64_t seed,
    int strokes_lo, int strokes_hi,
    int steps_lo, int steps_hi,
    int radius_lo, int radius_hi,
    double step_len_lo, double step_len_hi,
    int num_rects_lo, int num_rects_hi,
    double rect_frac_lo, double rect_frac_hi,
    int with_rects) {
  Rng rng(seed);
  const size_t n = static_cast<size_t>(h) * w;
  uint8_t* holes = new uint8_t[n]();

  const int64_t n_strokes = rng.randint(strokes_lo, strokes_hi);
  for (int64_t s = 0; s < n_strokes; ++s) {
    double y = rng.uniform(0, h);
    double x = rng.uniform(0, w);
    double angle = rng.uniform(0, 2 * M_PI);
    const int r = static_cast<int>(rng.randint(radius_lo, radius_hi));
    const int64_t steps = rng.randint(steps_lo, steps_hi);
    for (int64_t t = 0; t < steps; ++t) {
      stamp_disk(holes, h, w, y, x, r);
      angle += rng.uniform(-0.8, 0.8);
      const double len = rng.uniform(step_len_lo, step_len_hi);
      y = std::clamp(y + len * std::sin(angle), 0.0, h - 1.0);
      x = std::clamp(x + len * std::cos(angle), 0.0, w - 1.0);
    }
  }

  // rectangles with probability 0.5, matching data/masks.py::random_hole_mask
  if (with_rects && rng.uniform() < 0.5) {
    const int64_t n_rects = rng.randint(num_rects_lo, num_rects_hi);
    for (int64_t i = 0; i < n_rects; ++i) {
      const int rh = static_cast<int>(rng.uniform(rect_frac_lo, rect_frac_hi) * h);
      const int rw = static_cast<int>(rng.uniform(rect_frac_lo, rect_frac_hi) * w);
      const int y0 = static_cast<int>(rng.randint(0, std::max(1, h - rh)));
      const int x0 = static_cast<int>(rng.randint(0, std::max(1, w - rw)));
      for (int y = y0; y < std::min(h, y0 + rh); ++y)
        std::memset(holes + static_cast<size_t>(y) * w + x0, 1,
                    std::min(w, x0 + rw) - x0);
    }
  }

  for (size_t i = 0; i < n; ++i) out[i] = holes[i] ? 0.0f : 1.0f;
  delete[] holes;
}

// Batched variant: fills (batch, h, w) float32, one seed per sample.
void random_stroke_mask_batch(
    float* out, int batch, int h, int w, const uint64_t* seeds,
    int strokes_lo, int strokes_hi, int steps_lo, int steps_hi,
    int radius_lo, int radius_hi, double step_len_lo, double step_len_hi,
    int num_rects_lo, int num_rects_hi, double rect_frac_lo,
    double rect_frac_hi, int with_rects) {
  const size_t stride = static_cast<size_t>(h) * w;
  for (int b = 0; b < batch; ++b) {
    random_stroke_mask(out + b * stride, h, w, seeds[b], strokes_lo, strokes_hi,
                       steps_lo, steps_hi, radius_lo, radius_hi, step_len_lo,
                       step_len_hi, num_rects_lo, num_rects_hi, rect_frac_lo,
                       rect_frac_hi, with_rects);
  }
}

}  // extern "C"
