// Native host-side runtime for dgpmp2_tpu.
//
// The reference's only native code paths are scipy's C Euclidean distance
// transform (diff_gpmp2/utils/sdf_utils.py:17) and the external OMPL C++
// library used for RRT* expert-path generation (diff_gpmp2/ompl_rrtstar.py).
// This file provides self-contained C++ equivalents, exposed through a
// plain C ABI consumed via ctypes (no pybind11 dependency):
//
//   * edt_2d_sq   — exact squared Euclidean distance transform
//                   (Felzenszwalb & Huttenlocher lower-envelope algorithm,
//                   O(H*W)); batch-friendly.
//   * sdf_2d      — signed distance field from an occupancy mask
//                   (edt(occupied) - edt(free)) * res, matching
//                   dgpmp2_tpu.ops.sdf.sdf_from_occupancy.
//   * rrt_star_2d — RRT* motion planner on a 2-D world with SDF collision
//                   checking (state validity = sdf(x) > clearance, edge
//                   validity by interpolated checks), time-budgeted, with
//                   goal bias and shrinking rewire radius.  Replaces the
//                   reference's OMPL dependency for expert-data generation.
//
// Build: g++ -O3 -shared -fPIC -o libdgpmp2_native.so dgpmp2_native.cpp

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <random>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

// ---------------------------------------------------------------------------
// Exact EDT (Felzenszwalb & Huttenlocher, 1-D lower envelope of parabolas)
// ---------------------------------------------------------------------------

void dt1d(const float* f, float* d, int n, std::vector<int>& v,
          std::vector<float>& z) {
  v.resize(n);
  z.resize(n + 1);
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; ++q) {
    float s;
    while (true) {
      int p = v[k];
      s = ((f[q] + q * (float)q) - (f[p] + p * (float)p)) / (2.0f * (q - p));
      if (s <= z[k]) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    int p = v[k];
    d[q] = (q - p) * (float)(q - p) + f[p];
  }
}

void edt2d_sq_inplace(float* grid, int h, int w) {
  std::vector<int> v;
  std::vector<float> z;
  std::vector<float> col(std::max(h, w)), out(std::max(h, w));
  // Columns.
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) col[y] = grid[y * w + x];
    dt1d(col.data(), out.data(), h, v, z);
    for (int y = 0; y < h; ++y) grid[y * w + x] = out[y];
  }
  // Rows.
  for (int y = 0; y < h; ++y) {
    dt1d(grid + y * w, out.data(), w, v, z);
    std::memcpy(grid + y * w, out.data(), w * sizeof(float));
  }
}

// ---------------------------------------------------------------------------
// RRT* on a 2-D world with SDF validity
// ---------------------------------------------------------------------------

struct World {
  const float* sdf;  // (h, w) metric signed distances, row 0 = top of world
  int h, w;
  float x_lo, x_hi, y_lo, y_hi, res;

  float query(float x, float y) const {
    if (x < x_lo || x > x_hi || y < y_lo || y > y_hi) return x_hi - x_lo;
    float px = -x_lo / res + x / res;
    float py = -y_lo / res - y / res;
    int px1 = std::clamp((int)std::floor(px), 0, w - 1);
    int px2 = std::clamp(px1 + 1, 0, w - 1);
    int py1 = std::clamp((int)std::floor(py), 0, h - 1);
    int py2 = std::clamp(py1 + 1, 0, h - 1);
    float fx = px - std::floor(px);
    float fy = py - std::floor(py);
    float d11 = sdf[py1 * w + px1], d21 = sdf[py1 * w + px2];
    float d12 = sdf[py2 * w + px1], d22 = sdf[py2 * w + px2];
    return (1 - fx) * (1 - fy) * d11 + fx * (1 - fy) * d21 +
           (1 - fx) * fy * d12 + fx * fy * d22;
  }
};

struct Node {
  float x, y, cost;
  int parent;
};

float dist(float ax, float ay, float bx, float by) {
  return std::hypot(ax - bx, ay - by);
}

bool edge_valid(const World& world, float ax, float ay, float bx, float by,
                float clearance) {
  float len = dist(ax, ay, bx, by);
  int steps = std::max(2, (int)std::ceil(len / (0.5f * world.res)));
  for (int i = 0; i <= steps; ++i) {
    float t = (float)i / steps;
    if (world.query(ax + t * (bx - ax), ay + t * (by - ay)) <= clearance)
      return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Exact squared EDT of a binary mask (1 = feature). grid in/out: (h, w) f32.
void edt_2d_sq(const uint8_t* mask, float* out, int h, int w) {
  // Large *finite* background cost: +inf breaks the lower-envelope
  // intersection arithmetic (inf - inf), and s = -inf underflows the
  // envelope stack.  Anything above the max achievable squared distance
  // works; the transform clamps back below it.
  const float big = (float)(h * h + w * w + 1);
  for (int i = 0; i < h * w; ++i) out[i] = mask[i] ? 0.0f : big;
  edt2d_sq_inplace(out, h, w);
  for (int i = 0; i < h * w; ++i) out[i] = std::min(out[i], big);
}

// Signed distance field from a free-space mask (1 = free), metric units.
// Semantics match dgpmp2_tpu.ops.sdf.sdf_from_occupancy with padlen=1.
void sdf_2d(const uint8_t* free_mask, float* out, int h, int w, float res) {
  int hp = h + 2, wp = w + 2;
  std::vector<uint8_t> freep(hp * wp, 1), occp(hp * wp, 0);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      uint8_t f = free_mask[y * w + x];
      freep[(y + 1) * wp + (x + 1)] = f;
      occp[(y + 1) * wp + (x + 1)] = (uint8_t)(1 - f);
    }
  std::vector<float> d_occ(hp * wp), d_free(hp * wp);
  edt_2d_sq(occp.data(), d_occ.data(), hp, wp);
  edt_2d_sq(freep.data(), d_free.data(), hp, wp);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int i = (y + 1) * wp + (x + 1);
      out[y * w + x] =
          (std::sqrt(d_occ[i]) - std::sqrt(d_free[i])) * res;
    }
}

// RRT* plan from (sx, sy) to (gx, gy).  Returns the number of waypoints
// written to out_path (interleaved x, y; at most max_waypoints), or 0 if no
// path was found within the budget.  clearance = robot radius + margin.
int rrt_star_2d(const float* sdf, int h, int w, float x_lo, float x_hi,
                float y_lo, float y_hi, float sx, float sy, float gx, float gy,
                float clearance, float max_seconds, int max_iters,
                uint64_t seed, float* out_path, int max_waypoints) {
  World world{sdf, h, w, x_lo, x_hi, y_lo, y_hi, (x_hi - x_lo) / (float)w};
  if (world.query(sx, sy) <= clearance || world.query(gx, gy) <= clearance)
    return 0;

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> ux(x_lo, x_hi), uy(y_lo, y_hi),
      u01(0.0f, 1.0f);

  std::vector<Node> nodes;
  nodes.push_back({sx, sy, 0.0f, -1});
  int best_goal = -1;
  float best_cost = kInf;
  const float step_len = 0.1f * (x_hi - x_lo);
  const float goal_tol = 0.5f * step_len;
  const float gamma = 1.5f * (x_hi - x_lo);

  auto t0 = std::chrono::steady_clock::now();
  for (int it = 0; it < max_iters; ++it) {
    if ((it & 63) == 0) {
      float el = std::chrono::duration<float>(
                     std::chrono::steady_clock::now() - t0)
                     .count();
      if (el > max_seconds) break;
    }
    // Goal-biased sampling.
    float rx, ry;
    if (u01(rng) < 0.1f) {
      rx = gx;
      ry = gy;
    } else {
      rx = ux(rng);
      ry = uy(rng);
    }
    // Nearest node.
    int nearest = 0;
    float dn = kInf;
    for (int i = 0; i < (int)nodes.size(); ++i) {
      float d = dist(nodes[i].x, nodes[i].y, rx, ry);
      if (d < dn) {
        dn = d;
        nearest = i;
      }
    }
    // Steer.
    float nx = rx, ny = ry;
    if (dn > step_len) {
      nx = nodes[nearest].x + (rx - nodes[nearest].x) * step_len / dn;
      ny = nodes[nearest].y + (ry - nodes[nearest].y) * step_len / dn;
    }
    if (world.query(nx, ny) <= clearance) continue;

    // Choose parent among near nodes (shrinking radius).
    float radius = std::min(
        step_len * 2.0f,
        gamma * std::sqrt(std::log((float)nodes.size() + 1.0f) /
                          ((float)nodes.size() + 1.0f)));
    int parent = -1;
    float cost = kInf;
    std::vector<int> near;
    for (int i = 0; i < (int)nodes.size(); ++i) {
      float d = dist(nodes[i].x, nodes[i].y, nx, ny);
      if (d <= std::max(radius, step_len + 1e-6f)) near.push_back(i);
    }
    for (int i : near) {
      float d = dist(nodes[i].x, nodes[i].y, nx, ny);
      float c = nodes[i].cost + d;
      if (c < cost && edge_valid(world, nodes[i].x, nodes[i].y, nx, ny,
                                 clearance)) {
        cost = c;
        parent = i;
      }
    }
    if (parent < 0) continue;
    nodes.push_back({nx, ny, cost, parent});
    int ni = (int)nodes.size() - 1;

    // Rewire.
    for (int i : near) {
      float d = dist(nodes[i].x, nodes[i].y, nx, ny);
      float c = cost + d;
      if (c + 1e-6f < nodes[i].cost &&
          edge_valid(world, nx, ny, nodes[i].x, nodes[i].y, clearance)) {
        nodes[i].parent = ni;
        nodes[i].cost = c;
      }
    }

    // Goal connection.
    float dg = dist(nx, ny, gx, gy);
    if (dg < goal_tol &&
        edge_valid(world, nx, ny, gx, gy, clearance)) {
      float total = cost + dg;
      if (total < best_cost) {
        best_cost = total;
        best_goal = ni;
      }
    }
  }
  if (best_goal < 0) return 0;

  // Extract path (goal appended explicitly).
  std::vector<std::pair<float, float>> rev;
  rev.push_back({gx, gy});
  for (int i = best_goal; i >= 0; i = nodes[i].parent)
    rev.push_back({nodes[i].x, nodes[i].y});
  int n = std::min((int)rev.size(), max_waypoints);
  for (int i = 0; i < n; ++i) {
    out_path[2 * i] = rev[rev.size() - 1 - i].first;
    out_path[2 * i + 1] = rev[rev.size() - 1 - i].second;
  }
  return n;
}

}  // extern "C"
