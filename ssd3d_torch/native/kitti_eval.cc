// Native KITTI AP evaluator core.
//
// The port's copy of ssd3d/native/kitti_eval.cc. Implements the official
// devkit protocol exactly as ssd3d_torch/eval/kitti_ap.py does in numpy
// (both follow the reference's in-process C++ evaluator,
// lib/utils/tf_ops/evaluation/evaluate.cpp): difficulty gates, neighbor and
// DontCare handling, 41-recall-point thresholds, greedy per-GT assignment,
// right-max precision filtering. The Python layer (ssd3d_torch/native)
// builds this file with g++ into build/ssd3d_torch/ at first use and loads it
// via ctypes; use_native=False selects the numpy path, and tests
// cross-check both.
//
// C ABI only, loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumSample = 41;
constexpr double kMinHeight[3] = {40.0, 25.0, 25.0};
constexpr int kMaxOcclusion[3] = {0, 1, 2};
constexpr double kMaxTruncation[3] = {0.15, 0.3, 0.5};

// class codes from Python: 0=car 1=pedestrian 2=cyclist 3=van
// 4=person_sitting 5=dontcare -1=other
enum { CAR = 0, PED = 1, CYC = 2, VAN = 3, SITTER = 4, DONTCARE = 5 };

// GT row: cls, x1, y1, x2, y2, t1, t2, t3, l, h, w, ry, alpha, trunc, occ
constexpr int GT_STRIDE = 15;
// Det row: cls, x1, y1, x2, y2, t1, t2, t3, l, h, w, ry, alpha, score
constexpr int DET_STRIDE = 14;

struct Pt {
  double x, z;
};

// BEV footprint corners (same orientation convention as the Python side).
void bev_corners(const float* row, Pt out[4]) {
  double cx = row[5], cz = row[7];
  double l = row[8], w = row[10], ry = row[11];
  double c = std::cos(ry), s = std::sin(ry);
  double lx[4] = {l / 2, l / 2, -l / 2, -l / 2};
  double lz[4] = {w / 2, -w / 2, -w / 2, w / 2};
  for (int i = 0; i < 4; ++i) {
    out[i].x = c * lx[i] + s * lz[i] + cx;
    out[i].z = -s * lx[i] + c * lz[i] + cz;
  }
}

double polygon_area(const std::vector<Pt>& p) {
  double a = 0;
  int n = (int)p.size();
  for (int i = 0; i < n; ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % n];
    a += u.x * v.z - v.x * u.z;
  }
  return std::fabs(a) / 2.0;
}

double signed_area(const Pt* p, int n) {
  double a = 0;
  for (int i = 0; i < n; ++i) {
    a += p[i].x * p[(i + 1) % n].z - p[(i + 1) % n].x * p[i].z;
  }
  return a / 2.0;
}

// Sutherland–Hodgman: clip convex quad `sub` by convex quad `clip` (CCW).
double quad_intersection_area(const Pt sub_in[4], const Pt clip_in[4]) {
  Pt sub[4], clip[4];
  std::memcpy(sub, sub_in, sizeof(sub));
  std::memcpy(clip, clip_in, sizeof(clip));
  if (signed_area(sub, 4) < 0) std::swap(sub[1], sub[3]);
  if (signed_area(clip, 4) < 0) std::swap(clip[1], clip[3]);

  std::vector<Pt> poly(sub, sub + 4), next;
  for (int k = 0; k < 4 && !poly.empty(); ++k) {
    const Pt& p0 = clip[k];
    const Pt& p1 = clip[(k + 1) % 4];
    double ex = p1.x - p0.x, ez = p1.z - p0.z;
    next.clear();
    int n = (int)poly.size();
    for (int i = 0; i < n; ++i) {
      const Pt& a = poly[i];
      const Pt& b = poly[(i + 1) % n];
      double sa = ex * (a.z - p0.z) - ez * (a.x - p0.x);
      double sb = ex * (b.z - p0.z) - ez * (b.x - p0.x);
      if (sa >= 0) next.push_back(a);
      if ((sa >= 0) != (sb >= 0)) {
        double t = sa / (sa - sb);
        next.push_back({a.x + t * (b.x - a.x), a.z + t * (b.z - a.z)});
      }
    }
    poly.swap(next);
  }
  return poly.size() < 3 ? 0.0 : polygon_area(poly);
}

// metric: 0=image 1=ground 2=3d; criterion: -1 union, 0 det-normalized
double box_overlap(const float* det, const float* gt, int metric,
                   int criterion) {
  if (metric == 0) {
    double x1 = std::max(det[1], gt[1]), y1 = std::max(det[2], gt[2]);
    double x2 = std::min(det[3], gt[3]), y2 = std::min(det[4], gt[4]);
    double inter = std::max(0.0, x2 - x1) * std::max(0.0, y2 - y1);
    double a_d = (det[3] - det[1]) * (det[4] - det[2]);
    double a_g = (gt[3] - gt[1]) * (gt[4] - gt[2]);
    double denom = criterion == 0 ? a_d : a_d + a_g - inter;
    return inter / std::max(denom, 1e-12);
  }
  Pt cd[4], cg[4];
  bev_corners(det, cd);
  bev_corners(gt, cg);
  double inter = quad_intersection_area(cd, cg);
  double a_d = det[8] * det[10], a_g = gt[8] * gt[10];
  if (metric == 1) {
    double denom = criterion == 0 ? a_d : a_d + a_g - inter;
    return inter / std::max(denom, 1e-12);
  }
  // 3d: y spans [t2 - h, t2] (camera y down, bottom face at t2)
  double ymax = std::min(det[6], gt[6]);
  double ymin = std::max(det[6] - det[9], gt[6] - gt[9]);
  double ivol = inter * std::max(0.0, ymax - ymin);
  double v_d = a_d * det[9], v_g = a_g * gt[9];
  double denom = criterion == 0 ? v_d : v_d + v_g - ivol;
  return ivol / std::max(denom, 1e-12);
}

struct ImageData {
  const float* gt;
  int n_gt;
  const float* det;
  int n_det;
  std::vector<int> ignored_gt;   // 0 count, 1 ignore, -1 skip
  std::vector<int> ignored_det;  // 0 count, 1 small, -1 other class
  std::vector<int> dc;           // indices of DontCare GTs
  std::vector<double> overlap;     // [n_det, n_gt]
  std::vector<double> dc_overlap;  // [n_det, dc.size()]
};

void clean_data(ImageData& im, int cls, int difficulty, int* n_gt_total) {
  for (int i = 0; i < im.n_gt; ++i) {
    const float* g = im.gt + i * GT_STRIDE;
    int code = (int)g[0];
    int valid;
    if (code == cls)
      valid = 1;
    else if ((cls == PED && code == SITTER) || (cls == CAR && code == VAN))
      valid = 0;
    else
      valid = -1;
    double height = g[4] - g[2];
    bool ignore = g[14] > kMaxOcclusion[difficulty] ||
                  g[13] > kMaxTruncation[difficulty] ||
                  height <= kMinHeight[difficulty];
    if (valid == 1 && !ignore) {
      im.ignored_gt.push_back(0);
      ++*n_gt_total;
    } else if (valid == 0 || (ignore && valid == 1)) {
      im.ignored_gt.push_back(1);
    } else {
      im.ignored_gt.push_back(-1);
    }
    if (code == DONTCARE) im.dc.push_back(i);
  }
  for (int j = 0; j < im.n_det; ++j) {
    const float* d = im.det + j * DET_STRIDE;
    double height = std::fabs(d[4] - d[2]);
    if (height < kMinHeight[difficulty])
      im.ignored_det.push_back(1);
    else if ((int)d[0] == cls)
      im.ignored_det.push_back(0);
    else
      im.ignored_det.push_back(-1);
  }
}

struct Stat {
  int tp = 0, fp = 0, fn = 0;
  double similarity = 0;
  std::vector<double> scores;
};

Stat statistics(const ImageData& im, double min_overlap, bool compute_fp,
                double thresh, bool compute_aos) {
  constexpr double NO_DET = -1e7;
  Stat st;
  std::vector<char> assigned(im.n_det, 0), ign_thresh(im.n_det, 0);
  if (compute_fp)
    for (int j = 0; j < im.n_det; ++j)
      if (im.det[j * DET_STRIDE + 13] < thresh) ign_thresh[j] = 1;

  std::vector<double> deltas;
  for (int i = 0; i < im.n_gt; ++i) {
    if (im.ignored_gt[i] == -1) continue;
    int det_idx = -1;
    double valid_det = NO_DET, max_ov = 0;
    bool assigned_ignored = false;
    for (int j = 0; j < im.n_det; ++j) {
      if (im.ignored_det[j] == -1 || assigned[j] || ign_thresh[j]) continue;
      double ov = im.overlap[(size_t)j * im.n_gt + i];
      double score = im.det[j * DET_STRIDE + 13];
      if (!compute_fp) {
        if (ov > min_overlap && score > valid_det) {
          det_idx = j;
          valid_det = score;
        }
      } else if (ov > min_overlap && (ov > max_ov || assigned_ignored) &&
                 im.ignored_det[j] == 0) {
        max_ov = ov;
        det_idx = j;
        valid_det = 1;
        assigned_ignored = false;
      } else if (ov > min_overlap && valid_det == NO_DET &&
                 im.ignored_det[j] == 1) {
        det_idx = j;
        valid_det = 1;
        assigned_ignored = true;
      }
    }
    if (valid_det == NO_DET && im.ignored_gt[i] == 0) {
      ++st.fn;
    } else if (valid_det != NO_DET &&
               (im.ignored_gt[i] == 1 || im.ignored_det[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_det != NO_DET) {
      ++st.tp;
      st.scores.push_back(im.det[det_idx * DET_STRIDE + 13]);
      if (compute_aos)
        deltas.push_back(im.gt[i * GT_STRIDE + 12] -
                         im.det[det_idx * DET_STRIDE + 12]);
      assigned[det_idx] = 1;
    }
  }

  if (compute_fp) {
    for (int j = 0; j < im.n_det; ++j)
      if (!(assigned[j] || im.ignored_det[j] != 0 || ign_thresh[j])) ++st.fp;
    int nstuff = 0;
    for (size_t k = 0; k < im.dc.size(); ++k) {
      for (int j = 0; j < im.n_det; ++j) {
        if (assigned[j] || im.ignored_det[j] != 0 || ign_thresh[j]) continue;
        if (im.dc_overlap[(size_t)j * im.dc.size() + k] > min_overlap) {
          assigned[j] = 1;
          ++nstuff;
        }
      }
    }
    st.fp -= nstuff;
    if (compute_aos) {
      double sum = 0;
      for (double d : deltas) sum += (1.0 + std::cos(d)) / 2.0;
      st.similarity = (st.tp > 0 || st.fp > 0) ? sum : -1.0;
    }
  }
  return st;
}

}  // namespace

extern "C" {

// Returns 0 on success. precision_out/aos_out: kNumSample doubles each.
int kitti_eval_class(const float* gt_data, const int32_t* gt_counts,
                     const float* det_data, const int32_t* det_counts,
                     int32_t n_images, int32_t cls, int32_t difficulty,
                     int32_t metric, double min_overlap, int32_t compute_aos,
                     double* precision_out, double* aos_out) {
  std::vector<ImageData> images(n_images);
  const float* gp = gt_data;
  const float* dp = det_data;
  int n_gt_total = 0;
  std::vector<double> all_scores;

  for (int i = 0; i < n_images; ++i) {
    ImageData& im = images[i];
    im.gt = gp;
    im.n_gt = gt_counts[i];
    im.det = dp;
    im.n_det = det_counts[i];
    gp += (size_t)im.n_gt * GT_STRIDE;
    dp += (size_t)im.n_det * DET_STRIDE;
    clean_data(im, cls, difficulty, &n_gt_total);

    im.overlap.resize((size_t)im.n_det * im.n_gt);
    for (int j = 0; j < im.n_det; ++j)
      for (int g = 0; g < im.n_gt; ++g)
        im.overlap[(size_t)j * im.n_gt + g] = box_overlap(
            im.det + j * DET_STRIDE, im.gt + g * GT_STRIDE, metric, -1);
    im.dc_overlap.resize((size_t)im.n_det * im.dc.size());
    for (int j = 0; j < im.n_det; ++j)
      for (size_t k = 0; k < im.dc.size(); ++k)
        im.dc_overlap[(size_t)j * im.dc.size() + k] =
            box_overlap(im.det + j * DET_STRIDE,
                        im.gt + im.dc[k] * GT_STRIDE, metric, 0);

    Stat st = statistics(im, min_overlap, false, 0.0, false);
    all_scores.insert(all_scores.end(), st.scores.begin(), st.scores.end());
  }

  // recall thresholds (devkit getThresholds)
  std::sort(all_scores.begin(), all_scores.end(), std::greater<double>());
  std::vector<double> thresholds;
  double current = 0;
  int n = (int)all_scores.size();
  for (int i = 0; i < n; ++i) {
    double l_r = (double)(i + 1) / std::max(n_gt_total, 1);
    double r_r = i < n - 1 ? (double)(i + 2) / std::max(n_gt_total, 1) : l_r;
    if ((r_r - current) < (current - l_r) && i < n - 1) continue;
    thresholds.push_back(all_scores[i]);
    current += 1.0 / (kNumSample - 1.0);
  }

  int nt = (int)thresholds.size();
  std::vector<double> tp(nt, 0), fp(nt, 0), fn(nt, 0), sim(nt, 0);
  for (int i = 0; i < n_images; ++i) {
    for (int t = 0; t < nt; ++t) {
      Stat st = statistics(images[i], min_overlap, true, thresholds[t],
                           compute_aos != 0);
      tp[t] += st.tp;
      fp[t] += st.fp;
      fn[t] += st.fn;
      if (st.similarity != -1) sim[t] += st.similarity;
    }
  }

  for (int t = 0; t < kNumSample; ++t) {
    precision_out[t] = 0;
    if (aos_out) aos_out[t] = 0;
  }
  for (int t = 0; t < nt && t < kNumSample; ++t) {
    double denom = std::max(tp[t] + fp[t], 1e-12);
    precision_out[t] = tp[t] / denom;
    if (aos_out) aos_out[t] = sim[t] / denom;
  }
  for (int t = 0; t < nt && t < kNumSample; ++t) {
    for (int u = t; u < nt && u < kNumSample; ++u) {
      precision_out[t] = std::max(precision_out[t], precision_out[u]);
      if (aos_out) aos_out[t] = std::max(aos_out[t], aos_out[u]);
    }
  }
  return 0;
}

}  // extern "C"
