// Host C++ library of the port's evaluation: a copy of
// parq_tpu/native/native.cpp with the clip repaired (see `inside` and
// `intersect`) and NMS's order made stable (see `nms3d`), behind the same
// minimal C ABI (ctypes-loaded):
//   - lap_solve:    exact LAP via shortest augmenting path (Jonker-Volgenant)
//   - iou3d_pair/_matrix: BEV Sutherland-Hodgman clip + shoelace area 3D IoU
//   - nms3d:        greedy score-descending AABB NMS (class-agnostic / same-class)
//
// The reference leans on scipy's linear_sum_assignment, qhull and numba in
// its eval path (ref: utils/f1_eval.py:72-129, :318, :441); these are
// from-scratch equivalents. The IoU follows parq_torch/evals/iou3d.py, the
// plain version the tests hold it against to 1e-9.
//
// Build (parq_torch/native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 native.cpp -o native-<hash>.so

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// LAP: shortest augmenting path (rows <= cols). row_assign[r] = column.
// Mirrors the classic csa/scipy formulation.
// ---------------------------------------------------------------------------
int lap_solve(const double* cost, int nr, int nc, int* row_assign) {
  if (nr > nc) return -1;
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> u(nr, 0.0), v(nc, 0.0);
  std::vector<int> col4row(nr, -1), row4col(nc, -1);
  std::vector<double> shortest(nc);
  std::vector<int> path(nc);
  std::vector<char> SR(nr), SC(nc);

  for (int cur_row = 0; cur_row < nr; ++cur_row) {
    std::fill(shortest.begin(), shortest.end(), INF);
    std::fill(path.begin(), path.end(), -1);
    std::fill(SR.begin(), SR.end(), 0);
    std::fill(SC.begin(), SC.end(), 0);

    double min_val = 0.0;
    int i = cur_row;
    int sink = -1;
    while (sink == -1) {
      SR[i] = 1;
      int jmin = -1;
      double lowest = INF;
      for (int j = 0; j < nc; ++j) {
        if (SC[j]) continue;
        double r = min_val + cost[i * nc + j] - u[i] - v[j];
        if (r < shortest[j]) {
          shortest[j] = r;
          path[j] = i;
        }
        if (shortest[j] < lowest ||
            (shortest[j] == lowest && row4col[j] == -1)) {
          lowest = shortest[j];
          jmin = j;
        }
      }
      if (jmin < 0 || lowest == INF) return -2;  // infeasible
      min_val = lowest;
      SC[jmin] = 1;
      if (row4col[jmin] == -1) {
        sink = jmin;
      } else {
        i = row4col[jmin];
      }
    }

    u[cur_row] += min_val;
    for (int r = 0; r < nr; ++r) {
      if (SR[r] && r != cur_row) u[r] += min_val - shortest[col4row[r]];
    }
    for (int j = 0; j < nc; ++j) {
      if (SC[j]) v[j] -= min_val - shortest[j];
    }

    // augment
    int j = sink;
    while (true) {
      int r = path[j];
      row4col[j] = r;
      std::swap(col4row[r], j);
      if (r == cur_row) break;
    }
  }
  std::memcpy(row_assign, col4row.data(), nr * sizeof(int));
  return 0;
}

// ---------------------------------------------------------------------------
// BEV polygon clipping IoU (ODAM convention, as evals/iou3d.py).
// corners: 8x3 doubles, already reordered+rotated (to_odam output).
// ---------------------------------------------------------------------------
struct P2 {
  double x, y;
};

static double poly_area(const std::vector<P2>& p) {
  double s = 0.0;
  int n = (int)p.size();
  for (int i = 0; i < n; ++i) {
    int j = (i + n - 1) % n;
    s += p[j].x * p[i].y - p[i].x * p[j].y;
  }
  return std::fabs(s) * 0.5;
}

// A point on the clip line counts as inside. The JAX package's strict test
// drops the shared edges of coincident boxes, so the IoU of a rotated box
// with itself comes out NaN or wrong there.
static bool inside(const P2& p, const P2& a, const P2& b) {
  return (b.x - a.x) * (p.y - a.y) >= (b.y - a.y) * (p.x - a.x);
}

// The crossing of the subject edge s-e with the clip line a-b. An edge
// parallel to the clip line (it runs along it, and rounding put one end
// outside) crosses at `on_line`, that end, instead of dividing by zero.
static P2 intersect(const P2& a, const P2& b, const P2& s, const P2& e,
                    const P2& on_line) {
  double dcx = a.x - b.x, dcy = a.y - b.y;
  double dpx = s.x - e.x, dpy = s.y - e.y;
  double det = dcx * dpy - dcy * dpx;
  if (det == 0.0) return on_line;
  double n1 = a.x * b.y - a.y * b.x;
  double n2 = s.x * e.y - s.y * e.x;
  double n3 = 1.0 / det;
  return {(n1 * dpx - n2 * dcx) * n3, (n1 * dpy - n2 * dcy) * n3};
}

static bool polygon_clip(const std::vector<P2>& subject,
                         const std::vector<P2>& clip, std::vector<P2>& out) {
  out = subject;
  P2 cp1 = clip.back();
  for (const P2& cp2 : clip) {
    std::vector<P2> input = out;
    out.clear();
    if (input.empty()) return false;
    P2 s = input.back();
    for (const P2& e : input) {
      if (inside(e, cp1, cp2)) {
        if (!inside(s, cp1, cp2)) out.push_back(intersect(cp1, cp2, s, e, s));
        out.push_back(e);
      } else if (inside(s, cp1, cp2)) {
        out.push_back(intersect(cp1, cp2, s, e, e));
      }
      s = e;
    }
    cp1 = cp2;
    if (out.empty()) return false;
  }
  return true;
}

static double box3d_vol(const double* c) {
  auto dist = [&](int i, int j) {
    double dx = c[i * 3] - c[j * 3];
    double dy = c[i * 3 + 1] - c[j * 3 + 1];
    double dz = c[i * 3 + 2] - c[j * 3 + 2];
    return std::sqrt(dx * dx + dy * dy + dz * dz);
  };
  return dist(0, 1) * dist(1, 2) * dist(0, 4);
}

double iou3d_pair(const double* c1, const double* c2) {
  for (int i = 0; i < 24; ++i) {
    if (std::isnan(c1[i]) || std::isnan(c2[i])) return 0.0;
  }
  std::vector<P2> r1, r2;
  for (int i = 3; i >= 0; --i) {
    r1.push_back({c1[i * 3], c1[i * 3 + 2]});
    r2.push_back({c2[i * 3], c2[i * 3 + 2]});
  }
  double a1 = poly_area(r1), a2 = poly_area(r2);
  std::vector<P2> inter;
  double inter_area = 0.0;
  if (polygon_clip(r1, r2, inter) && inter.size() >= 3) {
    inter_area = poly_area(inter);
  }
  double ymax = std::min(c1[1], c2[1]);          // corner 0 y
  double ymin = std::max(c1[4 * 3 + 1], c2[4 * 3 + 1]);  // corner 4 y
  double inter_vol = inter_area * std::max(0.0, ymax - ymin);
  double v1 = box3d_vol(c1), v2 = box3d_vol(c2);
  double denom = v1 + v2 - inter_vol;
  if (denom <= 0.0) return 0.0;
  return inter_vol / denom;
}

void iou3d_matrix(const double* a, int na, const double* b, int nb,
                  double* out) {
  for (int i = 0; i < na; ++i)
    for (int j = 0; j < nb; ++j)
      out[i * nb + j] = iou3d_pair(a + i * 24, b + j * 24);
}

// ---------------------------------------------------------------------------
// Greedy 3D NMS over AABB rows [x1,y1,z1,x2,y2,z2,score,class].
// Boxes of equal score go in index order (a stable sort, as greedy_nms and
// nms_mask_device in parq_torch/evals/nms.py); the JAX copy's std::sort
// leaves their order to the library.
// ---------------------------------------------------------------------------
void nms3d(const double* rows, int n, double thresh, int same_class,
           unsigned char* keep) {
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return rows[a * 8 + 6] > rows[b * 8 + 6];
  });
  std::vector<double> area(n);
  for (int i = 0; i < n; ++i) {
    const double* r = rows + i * 8;
    area[i] = (r[3] - r[0]) * (r[4] - r[1]) * (r[5] - r[2]);
  }
  std::fill(keep, keep + n, 0);
  std::vector<int> kept;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    const double* ri = rows + i * 8;
    bool suppressed = false;
    for (int j : kept) {
      const double* rj = rows + j * 8;
      if (same_class && ri[7] != rj[7]) continue;
      double l = std::max(0.0, std::min(ri[3], rj[3]) - std::max(ri[0], rj[0]));
      double w = std::max(0.0, std::min(ri[4], rj[4]) - std::max(ri[1], rj[1]));
      double h = std::max(0.0, std::min(ri[5], rj[5]) - std::max(ri[2], rj[2]));
      double inter = l * w * h;
      double o = inter / (area[i] + area[j] - inter);
      if (o > thresh) {
        suppressed = true;
        break;
      }
    }
    if (!suppressed) {
      keep[i] = 1;
      kept.push_back(i);
    }
  }
}

}  // extern "C"
