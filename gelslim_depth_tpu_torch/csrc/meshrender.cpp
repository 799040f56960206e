// Host mesh -> contact-depth renderer: a multi-threaded C++ copy of the
// algorithm of meshgen/depth_render.py (same f32 arithmetic), the port's
// copy of the JAX package's native/meshrender.cpp. It renders on the host
// CPU, one sample per thread, with the two per-finger grids of a sample
// (~1.1 MB at 320x427) cache-resident; it moves nothing to or from a card.
//
// Semantics mirror render_depth_pair (reference contract:
// ref gelslim_depth/mesh_utils/depth_from_mesh.py:80-231):
//   1. center the cloud along the out-of-plane axis;
//   2. SE(2) in the gelslim plane (translations pre-scaled x1000 by the
//      caller, matching translation1*1000 in the torch path);
//   3. split at the midplane, clamp to the gel planes at +-width/2,
//      re-express as penetration depth (<= 0);
//   4. mirror the left finger's unaligned (row) axis;
//   5. min-splat onto the pixel grid (round-half-even like torch.round),
//      fill_iters synchronous iterations of occupied-3x3-average hole fill,
//      unoccupied pixels -> 0, floor at the half-cloud's min depth.
// Pixel indices may differ from the torch renderer's where libm's f32
// cos/sin differ by ULPs and move a point across a rounding boundary.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

struct Spec {
  int perp, aligned, unaligned, multiplier;
};

void render_one(const float* pc, int64_t P, float t1, float t2, float angle,
                float width, const Spec& s, int H, int W, float mmpp,
                int fill_iters, int invert, int lr_flip, float* out_pair,
                std::vector<float>& scratch) {
  const int64_t HW = static_cast<int64_t>(H) * W;
  // scratch layout: pc copy perp/u/v (3P) + grids (4 HW) + fill buffers (4 HW)
  scratch.assign(3 * P + 8 * HW, 0.0f);
  float* perp = scratch.data();
  float* uu = perp + P;       // unaligned coordinate (rows)
  float* vv = uu + P;         // aligned coordinate (cols)

  // in-plane axis order matches affine2d_points: sorted non-perp indices
  int ip0 = -1, ip1 = -1;
  for (int i = 0; i < 3; ++i) {
    if (i == s.perp) continue;
    if (ip0 < 0) ip0 = i; else ip1 = i;
  }
  float c = std::cos(angle), sn = std::sin(angle);
  float a_t1 = t1, a_t2 = t2;
  if (invert) {
    a_t1 = -(c * t1 + sn * t2);
    a_t2 = -(-sn * t1 + c * t2);
    sn = -sn;
  }

  float pmin = std::numeric_limits<float>::infinity();
  float pmax = -std::numeric_limits<float>::infinity();
  for (int64_t i = 0; i < P; ++i) {
    float p = pc[i * 3 + s.perp];
    pmin = std::min(pmin, p);
    pmax = std::max(pmax, p);
  }
  const float mid = 0.5f * (pmax + pmin);

  for (int64_t i = 0; i < P; ++i) {
    float u = pc[i * 3 + ip0];
    float v = pc[i * 3 + ip1];
    float nu = c * u - sn * v + a_t1;
    float nv = sn * u + c * v + a_t2;
    float coords[3];
    coords[s.perp] = pc[i * 3 + s.perp] - mid;
    coords[ip0] = nu;
    coords[ip1] = nv;
    perp[i] = coords[s.perp];
    uu[i] = coords[s.unaligned];
    vv[i] = coords[s.aligned];
  }

  const float m = static_cast<float>(s.multiplier);
  const float half = width * 0.5f;
  const float inf = std::numeric_limits<float>::infinity();

  float* grid_r = scratch.data() + 3 * P;
  float* grid_l = grid_r + HW;
  for (int64_t k = 0; k < 2 * HW; ++k) grid_r[k] = inf;

  float min_r = inf, min_l = inf;
  const float h_half = 0.5f * static_cast<float>(H);
  const float w_half = 0.5f * static_cast<float>(W);
  for (int64_t i = 0; i < P; ++i) {
    const float signed_d = m * perp[i];
    const float col_f = std::nearbyintf(vv[i] / mmpp + w_half);
    const int col = static_cast<int>(col_f);
    if (signed_d > 0.0f) {
      const float d = -(std::max(signed_d - half, 0.0f));
      min_r = std::min(min_r, d);
      const int row = static_cast<int>(std::nearbyintf(uu[i] / mmpp + h_half));
      if (row >= 0 && row < H && col >= 0 && col < W) {
        float& g = grid_r[static_cast<int64_t>(row) * W + col];
        g = std::min(g, d);
      }
    } else if (signed_d < 0.0f) {
      const float d = -(std::max(-signed_d - half, 0.0f));
      min_l = std::min(min_l, d);
      const int row = static_cast<int>(std::nearbyintf(-uu[i] / mmpp + h_half));
      if (row >= 0 && row < H && col >= 0 && col < W) {
        float& g = grid_l[static_cast<int64_t>(row) * W + col];
        g = std::min(g, d);
      }
    }
  }

  // hole fill (synchronous/double-buffered, matching _fill_holes): a 3x3
  // box sum over occupied values fills only previously-empty pixels
  float* vals = grid_l + HW;        // 2 HW
  float* occ = vals + 2 * HW;       // 2 HW (0/1 floats)
  for (int f = 0; f < 2; ++f) {
    const float* g = f == 0 ? grid_r : grid_l;
    for (int64_t k = 0; k < HW; ++k) {
      const bool o = std::isfinite(g[k]);
      vals[f * HW + k] = o ? g[k] : 0.0f;
      occ[f * HW + k] = o ? 1.0f : 0.0f;
    }
  }
  // separable 3x3 box sums (row pass then column pass), matching the torch
  // _box3 formulation — straight-line vectorizable loops, no branches
  std::vector<float> vo(HW), rs_v(HW), rs_o(HW), bs_v(HW), bs_o(HW);
  for (int it = 0; it < fill_iters; ++it) {
    for (int f = 0; f < 2; ++f) {
      float* v0 = vals + f * HW;
      float* o0 = occ + f * HW;
      for (int64_t k = 0; k < HW; ++k) vo[k] = v0[k] * o0[k];
      // vertical pass: rs[r] = x[r-1] + x[r] + x[r+1]
      for (int r = 0; r < H; ++r) {
        const float* up_v = r > 0 ? &vo[(r - 1) * W] : nullptr;
        const float* dn_v = r < H - 1 ? &vo[(r + 1) * W] : nullptr;
        const float* up_o = r > 0 ? &o0[static_cast<int64_t>(r - 1) * W] : nullptr;
        const float* dn_o = r < H - 1 ? &o0[static_cast<int64_t>(r + 1) * W] : nullptr;
        const float* mid_v = &vo[static_cast<int64_t>(r) * W];
        const float* mid_o = &o0[static_cast<int64_t>(r) * W];
        float* ov = &rs_v[static_cast<int64_t>(r) * W];
        float* oo = &rs_o[static_cast<int64_t>(r) * W];
        for (int cdx = 0; cdx < W; ++cdx) {
          ov[cdx] = mid_v[cdx] + (up_v ? up_v[cdx] : 0.0f) + (dn_v ? dn_v[cdx] : 0.0f);
          oo[cdx] = mid_o[cdx] + (up_o ? up_o[cdx] : 0.0f) + (dn_o ? dn_o[cdx] : 0.0f);
        }
      }
      // horizontal pass + update
      for (int r = 0; r < H; ++r) {
        const float* sv = &rs_v[static_cast<int64_t>(r) * W];
        const float* so = &rs_o[static_cast<int64_t>(r) * W];
        float* bv = bs_v.data();
        float* bo = bs_o.data();
        for (int cdx = 0; cdx < W; ++cdx) {
          const float lv = cdx > 0 ? sv[cdx - 1] : 0.0f;
          const float rv = cdx < W - 1 ? sv[cdx + 1] : 0.0f;
          const float lo = cdx > 0 ? so[cdx - 1] : 0.0f;
          const float ro = cdx < W - 1 ? so[cdx + 1] : 0.0f;
          bv[cdx] = sv[cdx] + lv + rv;
          bo[cdx] = so[cdx] + lo + ro;
        }
        float* v0r = v0 + static_cast<int64_t>(r) * W;
        float* o0r = o0 + static_cast<int64_t>(r) * W;
        for (int cdx = 0; cdx < W; ++cdx) {
          const float newly = (o0r[cdx] == 0.0f && bo[cdx] > 0.0f) ? 1.0f : 0.0f;
          const float neigh = bv[cdx] / std::max(bo[cdx], 1.0f);
          v0r[cdx] = newly != 0.0f ? neigh : v0r[cdx];
          o0r[cdx] = std::max(o0r[cdx], newly);
        }
      }
    }
  }

  const float floor_r = std::isfinite(min_r) ? min_r : 0.0f;
  const float floor_l = std::isfinite(min_l) ? min_l : 0.0f;
  // channel order: (left, right), or (right, left) when lr_flip
  float* ch0 = out_pair;
  float* ch1 = out_pair + HW;
  float* right_out = lr_flip ? ch0 : ch1;
  float* left_out = lr_flip ? ch1 : ch0;
  for (int64_t k = 0; k < HW; ++k) {
    const float vr = occ[k] != 0.0f ? vals[k] : 0.0f;
    const float vl = occ[HW + k] != 0.0f ? vals[HW + k] : 0.0f;
    right_out[k] = std::max(vr, floor_r);
    left_out[k] = std::max(vl, floor_l);
  }
}

}  // namespace

extern "C" {

// pc: (P, 3) f32 row-major (already scaled to mm by the caller).
// poses: (B, 3) rows (t1, t2, angle) with t1/t2 pre-scaled to mm.
// widths: (B,) mm. out: (B, 2, H, W) f32.
int render_depth_batch_native(const float* pc, int64_t P, const float* poses,
                              const float* widths, int64_t B, int perp,
                              int aligned, int unaligned, int multiplier,
                              int H, int W, float mm_per_pixel, int fill_iters,
                              int invert_affine, int lr_flip, float* out,
                              int n_threads) {
  if (P <= 0 || B <= 0 || H <= 0 || W <= 0) return 1;
  const Spec spec{perp, aligned, unaligned, multiplier};
  const int64_t pair_sz = 2LL * H * W;
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : (hw ? static_cast<int>(hw) : 4);
  nt = static_cast<int>(std::min<int64_t>(nt, B));

  auto work = [&](int tid) {
    std::vector<float> scratch;
    for (int64_t b = tid; b < B; b += nt) {
      render_one(pc, P, poses[b * 3 + 0], poses[b * 3 + 1], poses[b * 3 + 2],
                 widths[b], spec, H, W, mm_per_pixel, fill_iters,
                 invert_affine, lr_flip, out + b * pair_sz, scratch);
    }
  };
  if (nt <= 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  return 0;
}
}
