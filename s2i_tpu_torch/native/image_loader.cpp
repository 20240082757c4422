// Native host data-path: multithreaded JPEG decode + StackGAN image
// transform + multi-scale pyramid, C ABI for ctypes.
//
// Role (SURVEY.md §2 "TPU-native equivalent" column): the reference's host
// data path is torch DataLoader worker processes wrapping PIL; at the
// ≥256 images/sec/chip target the Python/PIL path becomes the bottleneck,
// so decode→crop→resize→augment→normalize→pyramid runs here in C++ worker
// threads writing straight into caller-owned float buffers (zero Python-side
// copies). PNG and exotic formats fall back to the PIL path in Python.
//
// This file is the port's copy of s2i_tpu/native/image_loader.cpp.
//
// Per-image pipeline (matches s2i_tpu_torch/data/stackgan.py::pil_load_transform):
//   1. decode JPEG (libjpeg, RGB); optional DCT-scaled decode (fast_decode)
//   2. optional bbox crop with 1.5x margin
//   3. bilinear resize to load_size = imsize * 76 / 64
//   4. random crop to imsize + random horizontal flip (or center crop)
//   5. normalize to [-1, 1] float32
//   6. area-pool the top scale into each smaller scale (÷2 per stage)
//
// Steps 3+4 run FUSED: only the imsize² samples the crop keeps are ever
// computed (the load_size² intermediate never exists) with the exact
// per-sample math + uint8 quantization of the two-pass formulation, so the
// output is bit-identical while skipping ~29% of the resize work and a full
// copy pass at imsize=256.
//
// fast_decode=1 additionally asks libjpeg(-turbo) for the smallest M/8
// DCT-scaled decode whose scaled crop REGION still covers load_size (no
// upsampling is ever introduced). IDCT cost drops with the square of the
// scale; output differs slightly from the full-res path (the bilinear
// source grid is coarser), so it is an opt-in throughput knob
// (DATA.FAST_DECODE), never the default.
//
// RNG: splitmix64 seeded per (seed, image-index) — deterministic given the
// batch seed, independent of thread scheduling.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Source crop window: bbox (x, y, w, h) scaled by (sx, sy) with the
// StackGAN 0.75*max-dim margin, clamped to the image; full image when bbox
// is null/degenerate. (sx, sy) map full-resolution bbox coordinates onto a
// DCT-scaled decode; they are exactly 1.0f for a full decode, keeping the
// integer truncation — and thus the output — bit-identical to the
// unscaled formulation.
void crop_region(const float* bb, float sx, float sy, int w, int h, int& x0,
                 int& y0, int& x1, int& y1) {
  x0 = 0;
  y0 = 0;
  x1 = w;
  y1 = h;
  if (!bb) return;
  float bx = bb[0] * sx, by = bb[1] * sy;
  float bw = bb[2] * sx, bh = bb[3] * sy;
  if (bw > 0 && bh > 0) {
    float cx = bx + bw / 2, cy = by + bh / 2;
    int r = static_cast<int>(fmaxf(bw, bh) * 0.75f);
    // keep the region non-empty and inside the frame even for degenerate
    // bboxes (r == 0, or a center outside the image): sample taps clamp to
    // [x0, x1) so x1 > x0 must hold
    x0 = std::min(std::max(0, static_cast<int>(cx) - r), w - 1);
    y0 = std::min(std::max(0, static_cast<int>(cy) - r), h - 1);
    x1 = std::min(w, std::max(static_cast<int>(cx) + r, x0 + 1));
    y1 = std::min(h, std::max(static_cast<int>(cy) + r, y0 + 1));
  }
}

// Decode a JPEG file to tightly-packed RGB8. Returns false on failure.
// With fast=true, picks the smallest libjpeg M/8 DCT scale whose scaled
// crop region (from bb, or the full frame) still covers load_size in both
// dims — the IDCT then produces ~ (M/8)² of the full-res pixels. (sx, sy)
// report decoded/full dims so the caller rescales bbox coordinates; both
// are exactly 1.0f when fast=false.
bool decode_jpeg(const char* path, std::vector<uint8_t>& rgb, int& w, int& h,
                 float& sx, float& sy, const float* bb, int load_size,
                 bool fast) {
  sx = 1.0f;
  sy = 1.0f;
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  if (fast && load_size > 0) {
    int fw = cinfo.image_width, fh = cinfo.image_height;
    int cx0, cy0, cx1, cy1;
    crop_region(bb, 1.0f, 1.0f, fw, fh, cx0, cy0, cx1, cy1);
    int den = std::min(cx1 - cx0, cy1 - cy0);
    int m = den <= load_size
                ? 8
                : static_cast<int>(
                      std::ceil(8.0 * load_size / den));
    m = std::max(1, std::min(8, m));
    // Round up to a power of two: libjpeg-turbo only SIMD-accelerates the
    // 8/8, 4/8, 2/8, 1/8 IDCTs — the other M/8 kernels are scalar C and
    // measure SLOWER than a full SIMD decode.
    while (m & (m - 1)) ++m;
    cinfo.scale_num = static_cast<unsigned>(m);
    cinfo.scale_denom = 8;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  sx = static_cast<float>(w) / cinfo.image_width;
  sy = static_cast<float>(h) / cinfo.image_height;
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Fused resize+crop+flip: writes the imsize×imsize crop window of
// "bilinear-resize region [x0,y0)-(x1,y1) to load_size², then crop at
// (ox, oy) and optionally mirror" straight into `top` (float pixel values
// in [0, 255]) WITHOUT materializing the load_size² intermediate.  Every
// kept sample runs the identical per-sample expressions — half-pixel
// centers, clamped taps, the same product order, and the same round-to-
// uint8 quantization — as the two-pass form, so the output is
// bit-identical; the (load_size² − imsize²) discarded samples and the
// crop copy pass are simply never executed. Per-column tap indices and
// weights are precomputed once per image (they are row-invariant).
void sample_crop_resize(const uint8_t* src, int sw, int sh, int x0, int y0,
                        int x1, int y1, int load_size, int imsize, int ox,
                        int oy, bool flip, int* ix0t, int* ix1t, float* wxt,
                        float* top) {
  const float rw = static_cast<float>(x1 - x0) / load_size;
  const float rh = static_cast<float>(y1 - y0) / load_size;
  for (int x = 0; x < imsize; ++x) {
    int sx = flip ? (ox + imsize - 1 - x) : (ox + x);
    // PIL-style half-pixel centers (same formula as the full-grid pass,
    // evaluated only at the resized-grid columns the crop keeps)
    float fx = x0 + (sx + 0.5f) * rw - 0.5f;
    int ix = static_cast<int>(floorf(fx));
    wxt[x] = fx - ix;
    // taps clamp to the CROP REGION, not the full decoded image: the PIL
    // path (stackgan.pil_load_transform) crops first and resizes the
    // cropped array, so its edge taps replicate the crop border — clamping
    // to [0, sw) here would sample pixels outside the bbox at region edges
    // and diverge from the "matches load_image" contract (no-bbox calls
    // have x0=0, x1=sw: identical either way)
    ix0t[x] = ix < x0 ? x0 : (ix >= x1 ? x1 - 1 : ix);
    ix1t[x] = ix + 1 < x0 ? x0 : (ix + 1 >= x1 ? x1 - 1 : ix + 1);
  }
  for (int y = 0; y < imsize; ++y) {
    float fy = y0 + (oy + y + 0.5f) * rh - 0.5f;
    int iy = static_cast<int>(floorf(fy));
    float wy = fy - iy;
    int iy0 = iy < y0 ? y0 : (iy >= y1 ? y1 - 1 : iy);
    int iy1 = iy + 1 < y0 ? y0 : (iy + 1 >= y1 ? y1 - 1 : iy + 1);
    const uint8_t* r0 = src + static_cast<size_t>(iy0) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(iy1) * sw * 3;
    float* out = top + static_cast<size_t>(y) * imsize * 3;
    for (int x = 0; x < imsize; ++x) {
      const float wx = wxt[x];
      const uint8_t* p00 = r0 + static_cast<size_t>(ix0t[x]) * 3;
      const uint8_t* p01 = r0 + static_cast<size_t>(ix1t[x]) * 3;
      const uint8_t* p10 = r1 + static_cast<size_t>(ix0t[x]) * 3;
      const uint8_t* p11 = r1 + static_cast<size_t>(ix1t[x]) * 3;
      for (int c = 0; c < 3; ++c) {
        float v00 = p00[c];
        float v01 = p01[c];
        float v10 = p10[c];
        float v11 = p11[c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        // same quantization the two-pass form applied when storing the
        // resized intermediate as uint8
        out[x * 3 + c] = static_cast<float>(static_cast<uint8_t>(
            v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f)));
      }
    }
  }
}

}  // namespace

namespace {

// OutT = float: values in [-1, 1] (x/127.5 - 1).
// OutT = uint8_t: raw [0, 255] — the device normalizes after transfer
// (4x fewer host->device bytes; see DATA.IMAGE_DTYPE).
template <typename OutT>
int load_batch_impl(const char** paths, int n, const float* bboxes, int imsize,
                    int branch_num, uint64_t seed, int augment, OutT** outs,
                    int num_threads, int fast_decode) {
  const int load_size = imsize * 76 / 64;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};

  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    // top scale kept as float pixel values in [0, 255]: the pyramid
    // area-pool averages in that space for both output types, so the two
    // paths differ only by the final quantization/normalization.
    std::vector<float> top(static_cast<size_t>(imsize) * imsize * 3);
    // per-column bilinear tap tables (row-invariant, rebuilt per image)
    std::vector<int> ix0t(imsize), ix1t(imsize);
    std::vector<float> wxt(imsize);
    auto store = [](float v255, OutT* o) {
      if (sizeof(OutT) == 1) {
        float r = v255 + 0.5f;
        *o = static_cast<OutT>(r < 0 ? 0 : (r > 255 ? 255 : r));
      } else {
        *o = static_cast<OutT>(v255 / 127.5f - 1.0f);
      }
    };
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const float* bb = bboxes ? bboxes + static_cast<size_t>(i) * 4 : nullptr;
      int w = 0, h = 0;
      float sx = 1.0f, sy = 1.0f;
      bool ok = decode_jpeg(paths[i], rgb, w, h, sx, sy, bb, load_size,
                            fast_decode != 0);
      if (!ok) {
        failures.fetch_add(1);
        for (int b = 0; b < branch_num; ++b) {
          int s = (imsize >> (branch_num - 1)) << b;
          memset(outs[b] + static_cast<size_t>(i) * s * s * 3, 0,
                 static_cast<size_t>(s) * s * 3 * sizeof(OutT));
        }
        continue;
      }
      int x0, y0, x1, y1;
      crop_region(bb, sx, sy, w, h, x0, y0, x1, y1);

      uint64_t s = seed * 0x9e3779b97f4a7c15ULL + i + 1;
      int ox, oy;
      bool flip = false;
      if (augment) {
        ox = static_cast<int>(splitmix64(s) % (load_size - imsize + 1));
        oy = static_cast<int>(splitmix64(s) % (load_size - imsize + 1));
        flip = (splitmix64(s) & 1) != 0;
      } else {
        ox = oy = (load_size - imsize) / 2;
      }
      sample_crop_resize(rgb.data(), w, h, x0, y0, x1, y1, load_size, imsize,
                         ox, oy, flip, ix0t.data(), ix1t.data(), wxt.data(),
                         top.data());
      // write pyramid: area-pool by 2^(branch-1-b)
      for (int b = 0; b < branch_num; ++b) {
        int shift = branch_num - 1 - b;
        int sc = imsize >> shift;
        int f = 1 << shift;
        OutT* dst = outs[b] + static_cast<size_t>(i) * sc * sc * 3;
        float inv = 1.0f / (f * f);
        for (int y = 0; y < sc; ++y) {
          for (int x = 0; x < sc; ++x) {
            float acc[3] = {0, 0, 0};
            for (int dy = 0; dy < f; ++dy)
              for (int dx = 0; dx < f; ++dx) {
                const float* px =
                    top.data() +
                    (static_cast<size_t>(y * f + dy) * imsize + x * f + dx) * 3;
                acc[0] += px[0];
                acc[1] += px[1];
                acc[2] += px[2];
              }
            OutT* o = dst + (static_cast<size_t>(y) * sc + x) * 3;
            store(acc[0] * inv, o + 0);
            store(acc[1] * inv, o + 1);
            store(acc[2] * inv, o + 2);
          }
        }
      }
    }
  };

  int nt = num_threads > 0 ? num_threads : 4;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // namespace

extern "C" {

// Load one batch. Returns number of failed images (their slots are zeroed;
// caller retries those via the PIL fallback).
//   paths:      n C strings
//   bboxes:     n*4 floats (x, y, w, h) or nullptr
//   imsize:     top-scale size (e.g. 256)
//   branch_num: number of pyramid scales (1..3), base = imsize >> (branch-1)
//   seed:       batch seed for crop/flip rng
//   augment:    1 = random crop + flip, 0 = center crop
//   outs:       branch_num pointers, outs[i] = float[n, s_i, s_i, 3] NHWC,
//               s_i = base << i, values in [-1, 1]
//   num_threads
//   fast_decode: 1 = DCT-scaled decode (opt-in approximation, see header)
int il_load_batch(const char** paths, int n, const float* bboxes, int imsize,
                  int branch_num, uint64_t seed, int augment, float** outs,
                  int num_threads, int fast_decode) {
  return load_batch_impl<float>(paths, n, bboxes, imsize, branch_num, seed,
                                augment, outs, num_threads, fast_decode);
}

// Same pipeline, uint8 [0, 255] outputs (device-side normalization):
// identical decode/crop/flip/area-pool math, final store rounds instead of
// normalizing — 4x fewer host->device bytes per batch.
int il_load_batch_u8(const char** paths, int n, const float* bboxes,
                     int imsize, int branch_num, uint64_t seed, int augment,
                     uint8_t** outs, int num_threads, int fast_decode) {
  return load_batch_impl<uint8_t>(paths, n, bboxes, imsize, branch_num, seed,
                                  augment, outs, num_threads, fast_decode);
}

// Decode-only entry (shape probe / tests): returns 0 on success.
int il_probe(const char* path, int* w, int* h) {
  std::vector<uint8_t> rgb;
  float sx, sy;
  return decode_jpeg(path, rgb, *w, *h, sx, sy, nullptr, 0, false) ? 0 : 1;
}

}  // extern "C"
