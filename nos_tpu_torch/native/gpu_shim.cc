// nos_tpu_torch native scheduling shim: host C++, no device code.
//
// The batch Filter screen, the Score argmin and the preemption walk's
// empty-node screen of the scheduler and the planner, as plain C
// functions loaded with ctypes.CDLL (nos_tpu_torch/device/native.py),
// which releases the GIL for each call: plan shards screening at once
// overlap inside these calls.  Built with g++ at first use into
// nos_tpu_torch/_kernels/ (ops/_build.py, build_host).
//
// The shim decides nothing on its own.  Each function replays a Python
// rule on the same numbers, and the Python stays the reference the
// tests hold it against:
//   nos_fit_batch        NodeResourcesFit.filter (scheduler/framework.py)
//   nos_score_batch      Scheduler._score_key's argmin
//   nos_window_busy      the sorted window-busy table the argmin reads
//                        (Scheduler._busy_score_arrays)
//   nos_victim_prescreen capacityscheduling._fits_empty
//   nos_gil_handshake    proves the binding drops the GIL
//
// Not ported from the JAX package's tpu_shim.cc:
//   nos_runtime_*    stand in for the TPU runtime's device table; the
//                    port reads the card through NVML (device/nvml.py)
//                    and tests against its fake (testing/nvml.py).
//   nos_pack         the exact cuboid search for TPU host blocks of up
//                    to 64 chips; a GPU's MIG search covers its 8 memory
//                    slots and is memoised in Python
//                    (topology/packing.py).

#include <algorithm>
#include <array>
#include <chrono>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Batch resource fit: n_nodes x n_classes verdicts of
// NodeResourcesFit.filter on the same doubles.
//   fit(i, j) = every resource r with req[j][r] > 0 has
//               free[i][r] >= req[j][r];
//   then, where every resource fits and class_g[j] > 0, the two
//   aggregate guards in the Python's order:
//     compute: used_g[i] + class_g[j] <= cap_g[i]   (miss bit 63)
//     memory:  used_m[i] + class_m[j] <= cap_m[i]   (miss bit 62)
// free_m: n_nodes*n_res (a row a node, the caller's resource order);
// req_m: n_classes*n_res.  out: n_nodes*n_classes bytes (1 = fits).
// miss_out (may be null): per (node, class) the failing resource
// indices as bits, and a guard's bit, from which the caller rebuilds
// NodeResourcesFit's message.  Returns 0, or -3 on bad arguments
// (n_res must leave bits 62 and 63 free).  Stateless.
int nos_fit_batch(const double* free_m, const double* req_m,
                  const double* cap_g, const double* used_g,
                  const double* cap_m, const double* used_m,
                  const double* class_g, const double* class_m,
                  int n_nodes, int n_classes, int n_res,
                  uint8_t* out, uint64_t* miss_out) {
  if (n_nodes < 0 || n_classes < 0 || n_res < 0 || n_res > 62 ||
      !free_m || !req_m || !cap_g || !used_g || !cap_m || !used_m ||
      !class_g || !class_m || !out)
    return -3;
  for (int i = 0; i < n_nodes; ++i) {
    const double* free_row = free_m + (size_t)i * n_res;
    for (int j = 0; j < n_classes; ++j) {
      const double* req_row = req_m + (size_t)j * n_res;
      uint64_t miss = 0;
      for (int r = 0; r < n_res; ++r) {
        double v = req_row[r];
        if (v > 0 && free_row[r] < v) miss |= 1ull << r;
      }
      if (!miss && class_g[j] > 0) {
        if (used_g[i] + class_g[j] > cap_g[i])
          miss = 1ull << 63;
        else if (used_m[i] + class_m[j] > cap_m[i])
          miss = 1ull << 62;
      }
      out[(size_t)i * n_classes + j] = miss ? 0 : 1;
      if (miss_out) miss_out[(size_t)i * n_classes + j] = miss;
    }
  }
  return 0;
}

// Score argmin backing Scheduler._choose_node: the index of the least
// (avoided, headroom, window_penalty, host_index, name_rank) tuple over
// n candidates, compared lexicographically (rank is the candidate's
// place in sorted name order, so no two tie).  The window penalty of
// candidate i with window group gid[i] >= 0 sums, over its window sizes
// wsizes[woff[i]..woff[i+1]), each size whose aligned window
// [(widx/size)*size, +size) stands wholly in the sorted (busy_gid,
// busy_idx, busy_val) table with every slot idle (val == 0).
// gid[i] < 0 or m == 0 gives penalty 0 (a node with no window, or an
// empty table).  Window indexes must be non-negative: C's division
// truncates where Python's floors.  Returns 0, or -3 on bad arguments
// (a non-positive window size among them).  Stateless.
int nos_score_batch(const uint8_t* avoided, const double* headroom,
                    const long long* gid, const long long* widx,
                    const long long* hidx, const long long* rank,
                    const long long* wsizes, const long long* woff,
                    const long long* busy_gid, const long long* busy_idx,
                    const uint8_t* busy_val, long long n, long long m,
                    long long* out_index) {
  if (n < 1 || m < 0 || !avoided || !headroom || !gid || !widx ||
      !hidx || !rank || !wsizes || !woff || !busy_gid || !busy_idx ||
      !busy_val || !out_index)
    return -3;
  for (long long i = 0; i < n; ++i)
    if (gid[i] >= 0)
      for (long long k = woff[i]; k < woff[i + 1]; ++k)
        if (wsizes[k] <= 0) return -3;
  // lower_bound on the sorted (gid, idx) pairs: true iff the slot is in
  // the table, with *idle set from its value
  auto probe = [&](long long g, long long x, bool* idle) -> bool {
    long long lo = 0, hi = m;
    while (lo < hi) {
      long long mid = lo + (hi - lo) / 2;
      if (busy_gid[mid] < g || (busy_gid[mid] == g && busy_idx[mid] < x))
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo >= m || busy_gid[lo] != g || busy_idx[lo] != x) return false;
    *idle = busy_val[lo] == 0;
    return true;
  };
  auto penalty = [&](long long i) -> long long {
    if (gid[i] < 0 || m == 0) return 0;
    long long pen = 0;
    for (long long k = woff[i]; k < woff[i + 1]; ++k) {
      long long size = wsizes[k];
      long long start = (widx[i] / size) * size;
      bool whole = true;
      for (long long w = start; w < start + size && whole; ++w) {
        bool idle = false;
        if (!probe(gid[i], w, &idle) || !idle) whole = false;
      }
      if (whole) pen += size;
    }
    return pen;
  };
  long long best = 0;
  long long best_pen = penalty(0);
  for (long long i = 1; i < n; ++i) {
    if (avoided[i] != avoided[best]) {
      if (avoided[i] < avoided[best]) { best = i; best_pen = penalty(i); }
      continue;
    }
    if (headroom[i] != headroom[best]) {
      if (headroom[i] < headroom[best]) { best = i; best_pen = penalty(i); }
      continue;
    }
    long long pen = penalty(i);
    if (pen != best_pen) {
      if (pen < best_pen) { best = i; best_pen = pen; }
      continue;
    }
    if (hidx[i] != hidx[best]) {
      if (hidx[i] < hidx[best]) { best = i; }
      continue;
    }
    if (rank[i] < rank[best]) { best = i; }
  }
  *out_index = best;
  return 0;
}

// Empty-node screen backing CapacityScheduling._victim_screen: could
// the preemptor fit node i with every pod evicted?  out[i] = 1 iff
// every resource r has req[r] <= 0 or alloc[i*n_res + r] >= req[r],
// and, where pod_g > 0, pod_g <= cap_g[i] and pod_m <= cap_m[i]:
// NodeResourcesFit at zero occupancy (_fits_empty).  Returns 0, or -3
// on bad arguments.  Stateless.
// The window-busy table of the score's window terms, sorted in place:
// n (group id, host index, busy) triples in lexicographic order, so
// nos_score_batch can binary-search a window's members.  The triples'
// keys are unique (a dict's), so the sort is Python's sorted() over
// them.  -3 on a null array with n > 0 or a negative n.
int nos_window_busy(long long* gid, long long* idx, uint8_t* val,
                    long long n) {
  if (n < 0 || (n > 0 && (!gid || !idx || !val))) return -3;
  std::vector<std::array<long long, 3>> triples((size_t)n);
  for (long long i = 0; i < n; ++i)
    triples[(size_t)i] = {gid[i], idx[i], (long long)val[i]};
  std::sort(triples.begin(), triples.end());
  for (long long i = 0; i < n; ++i) {
    gid[i] = triples[(size_t)i][0];
    idx[i] = triples[(size_t)i][1];
    val[i] = (uint8_t)triples[(size_t)i][2];
  }
  return 0;
}

int nos_victim_prescreen(const double* alloc, const double* req,
                         const long long* cap_g, const long long* cap_m,
                         long long pod_g, long long pod_m,
                         long long n, long long n_res, uint8_t* out) {
  if (n < 0 || n_res < 0 || !alloc || !req || !cap_g || !cap_m || !out)
    return -3;
  for (long long i = 0; i < n; ++i) {
    const double* row = alloc + (size_t)i * (size_t)n_res;
    bool ok = true;
    for (long long r = 0; ok && r < n_res; ++r)
      if (req[r] > 0 && row[r] < req[r]) ok = false;
    if (ok && pod_g > 0)
      ok = pod_g <= cap_g[i] && pod_m <= cap_m[i];
    out[i] = ok ? 1 : 0;
  }
  return 0;
}

// Two-party handshake proving the binding releases the GIL.  The
// caller zeroes `cell` and calls this from two threads at once.  Each
// increments the cell and spins until it reads 2 or the deadline
// passes: both return 1 only if both threads were inside this function
// together, which a binding that holds the GIL (PyDLL) never allows.
// Returns 0 at the deadline, -3 on bad arguments.
int nos_gil_handshake(long long* cell, double timeout_s) {
  if (!cell || timeout_s < 0) return -3;
  using steady = std::chrono::steady_clock;
  const auto deadline =
      steady::now() + std::chrono::duration_cast<steady::duration>(
                          std::chrono::duration<double>(timeout_s));
  __atomic_fetch_add(cell, 1, __ATOMIC_SEQ_CST);
  while (__atomic_load_n(cell, __ATOMIC_SEQ_CST) < 2) {
    if (steady::now() >= deadline) return 0;
    std::this_thread::yield();
  }
  return 1;
}

}  // extern "C"
