// One level of the pool linearizability search, as four kernels for Hopper.
//
// Replaces the XLA program that jax.jit compiles from the search body
// _search_fn in jepsen_tpu/checker/tpu.py (rows B1-B7 of the device-program
// table in PERF.md). The plain PyTorch version of every kernel sits beside its
// wrapper in jepsen_tpu_torch/kernels/search.py; the two agree bit for bit.
//
// Layouts (all int32; mask words hold uint32 bit patterns):
//   pool   k[C], mask[C][MW], cmask[C][MCX], state[C], alive[C] (uint8)
//   row    key1, k, mask[MW], state, popcount(cmask), cmask[MCX]  (NK words)
//   scal   done, lossy, wovf, level, best_k, live rows, active, spare
//   acc    per-level sums: done, best, lossy, expanded, dup, dominated,
//          trunc, frontier, block ticket; zero between levels
//
// The level is launch-bound at the headline rung (R = 512 rows: a few
// microseconds of work per kernel) and bound by the sort's bytes on the wide
// rungs (R up to ~1M rows). So every kernel is one launch where one block
// suffices, nothing synchronises with the host, and the `active` flag that
// makes a finished search's levels no-ops is read on the device.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (jepsen_tpu_torch/kernels/build.py). Plain C
// interface; every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXK = 1 << 30;
constexpr int RET_INF = 0x7fffffff;
constexpr int PAD_KEY = 0x7fffffff;
constexpr int LEADERS = 8;
constexpr int NSTAT = 5;
constexpr int MAXW = 4;  // mask words: windows and crashed sets up to 128
constexpr unsigned FULL = 0xffffffffu;

enum { DONE, LOSSY, WOVF, LEVEL, BEST, NALIVE, ACT };
enum { A_DONE, A_BEST, A_LOSSY, A_EXPANDED, A_DUP, A_DOM, A_TRUNC,
       A_FRONTIER, A_TICKET, NACC };

struct Cols {
  const int *f, *v1, *v2, *ro, *fr, *inv, *ret, *sm, *cf, *cv1, *cv2, *cinv,
      *cps;
};

struct PoolIn {
  const int* k;
  const unsigned* mask;
  const unsigned* cmask;
  const int* state;
  const uint8_t* alive;
};

struct PoolOut {
  int* k;
  unsigned* mask;
  unsigned* cmask;
  int* state;
  uint8_t* alive;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// B1: the CAS-register step (jepsen_tpu/models/core.py:375).
__device__ __forceinline__ int cas_step(int s, int f, int v1, int v2,
                                        bool& ok) {
  const bool cas_ok = s == v1;
  const bool is_write = f == 1;
  const bool take_cas = f == 2 && cas_ok;
  ok = (f == 0 && (v1 == -1 || cas_ok)) || is_write || take_cas;
  return take_cas ? v2 : (is_write ? v1 : s);
}

// B2: whole-mask bit helpers (tpu.py:122-161).
__device__ __forceinline__ int trailing_ones(const unsigned* m, int MW) {
  int t = 0;
  for (int w = 0; w < MW; ++w) {
    const unsigned z = ~m[w];
    const int tw = z ? __ffs(z) - 1 : 32;
    t += tw;
    if (tw < 32) break;
  }
  return t;
}

__device__ __forceinline__ void shr1(const unsigned* m, unsigned* out,
                                     int MW) {
  for (int w = 0; w < MW; ++w)
    out[w] = (m[w] >> 1) | (w + 1 < MW ? m[w + 1] << 31 : 0u);
}

__device__ __forceinline__ void shr_by(const unsigned* m, int t,
                                       unsigned* out, int MW) {
  const int ws = t >> 5, bs = t & 31;
  for (int w = 0; w < MW; ++w) {
    const unsigned a = w + ws < MW ? m[w + ws] : 0u;
    const unsigned b = w + ws + 1 < MW ? m[w + ws + 1] : 0u;
    out[w] = (a >> bs) | (bs ? b << (32 - bs) : 0u);
  }
}

__device__ __forceinline__ bool bit(const unsigned* m, int o) {
  return (m[o >> 5] >> (o & 31)) & 1u;
}

__device__ __forceinline__ void write_row(int* row, int k, const unsigned* m,
                                          int MW, const unsigned* cm,
                                          int MCX, int s, bool valid) {
  int pm = 0, pc = 0;
  for (int w = 0; w < MW; ++w) pm += __popc(m[w]);
  for (int w = 0; w < MCX; ++w) pc += __popc(cm[w]);
  row[0] = valid ? MAXK - (k + pm) : MAXK + 1 + k;
  row[1] = k;
  for (int w = 0; w < MW; ++w) row[2 + w] = (int)m[w];
  row[2 + MW] = s;
  row[3 + MW] = pc;
  for (int w = 0; w < MCX; ++w) row[4 + MW + w] = (int)cm[w];
}

// B4: the first frontier whose return exceeds the smallest untaken crashed
// invocation: searchsorted(ret, umin, side="right") (tpu.py:294-306).
__device__ int crash_bound(const unsigned* cm, const Cols& c, int n, int CR) {
  if (CR == 0) return n;
  int umin = RET_INF;
  for (int i = 0; i < CR; ++i) umin = min(umin, bit(cm, i) ? RET_INF : c.cinv[i]);
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c.ret[mid] <= umin) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// B4: advance through a run of forced ops (tpu.py:308-346).
__device__ void fast_forward(int& kk, int& ss, bool go, int bound,
                             const Cols& c, int n, int nr) {
  while (go) {
    const int kc = clampi(kk, 0, n - 1);
    bool ok;
    const int s2 = cas_step(ss, c.f[kc], c.v1[kc], c.v2[kc], ok);
    go = c.fr[kc] > 0 && kk < bound && kk < nr && ok;
    if (go) {
      kk += 1;
      ss = s2;
    }
  }
}

// ---------------------------------------------------------------------------
// K1 expand (B1-B4; tpu.py:380-506). One 128-thread block per expanded row:
// thread o < W computes required candidate o, thread c < CR crashed
// candidate c; warp w's ballot is word w of the closure's pure bits; thread 0
// runs the two fast-forwards. Blocks past E copy the pool remainder and write
// the sort's pad rows. Work per level is E*(W+CR) model steps: at the
// headline rung a few thousand, so the kernel costs its launch.
// ---------------------------------------------------------------------------

struct ExpandArgs {
  Cols c;
  PoolIn pool;
  int* scal;
  int* acc;
  int* rows;
  int C, W, E, n, CR, MW, MCX, NK, R, RP, nr, lmax;
};

__global__ void __launch_bounds__(128) expand_kernel(ExpandArgs a) {
  const int t = threadIdx.x;
  const bool act =
      a.scal[DONE] == 0 && a.scal[NALIVE] > 0 && a.scal[LEVEL] <= a.lmax;
  if (blockIdx.x == 0 && t == 0) a.scal[ACT] = act;
  if (!act) return;
  const int MW = a.MW, MCX = a.MCX, NK = a.NK, n = a.n;

  if ((int)blockIdx.x >= a.E) {  // pool remainder, then pad rows
    const int i = (blockIdx.x - a.E) * blockDim.x + t;
    const int nrem = a.C - a.E;
    if (i < nrem) {
      const int p = a.E + i;
      unsigned m[MAXW], cm[MAXW];
      for (int w = 0; w < MW; ++w) m[w] = a.pool.mask[p * MW + w];
      for (int w = 0; w < MCX; ++w) cm[w] = a.pool.cmask[p * MCX + w];
      write_row(a.rows + (size_t)(a.E * (a.W + 1 + a.CR) + i) * NK,
                a.pool.k[p], m, MW, cm, MCX, a.pool.state[p],
                a.pool.alive[p] != 0);
    } else if (i < nrem + (a.RP - a.R)) {
      int* row = a.rows + (size_t)(a.R + i - nrem) * NK;
      row[0] = PAD_KEY;
      for (int w = 1; w < NK; ++w) row[w] = 0;
    }
    return;
  }

  __shared__ unsigned s_pure[4];
  const int r = blockIdx.x;
  const int ke = a.pool.k[r];
  const bool ae = a.pool.alive[r] != 0;
  const int se = a.pool.state[r];
  unsigned me[MAXW], cme[MAXW];
  for (int w = 0; w < MAXW; ++w) {
    me[w] = w < MW ? a.pool.mask[r * MW + w] : 0u;
    cme[w] = w < MCX ? a.pool.cmask[r * MCX + w] : 0u;
  }
  const int retk = a.c.ret[clampi(ke, 0, n - 1)];
  if (t == 0 && ae) {
    atomicAdd(&a.acc[A_EXPANDED], 1);
    if (a.c.sm[clampi(ke + a.W, 0, n)] < retk) atomicOr(&a.scal[WOVF], 1);
  }

  // the [E, W] required grid: candidate t
  bool pure = false, valid = false;
  int s2 = se;
  if (t < a.W) {
    const int j = ke + t, jc = clampi(j, 0, n - 1);
    const bool cand = ae && j < n && a.c.inv[jc] < retk && !bit(me, t);
    bool ok;
    s2 = cas_step(se, a.c.f[jc], a.c.v1[jc], a.c.v2[jc], ok);
    pure = cand && ok && a.c.ro[jc] > 0;
    valid = cand && ok && !pure;
  }
  const unsigned bal = __ballot_sync(FULL, pure);
  if ((t & 31) == 0) s_pure[t >> 5] = bal;
  __syncthreads();
  unsigned pb[MAXW];
  bool any_pure = false;
  for (int w = 0; w < MAXW; ++w) {
    pb[w] = w < MW ? s_pure[w] : 0u;
    any_pure = any_pure || pb[w] != 0u;
  }
  const bool closure_ok = ae && any_pure;
  valid = valid && !closure_ok;

  const int grid_rows = a.E * a.W;
  if (t == 0) {
    const int bound = crash_bound(cme, a.c, n, a.CR);
    // offset 0: advance the frontier past linearized ops, then fast-forward
    unsigned m1[MAXW], madv[MAXW];
    shr1(me, m1, MW);
    const int t1 = trailing_ones(m1, MW);
    shr_by(m1, t1, madv, MW);
    int kadv = ke + 1 + t1, s0 = s2;
    fast_forward(kadv, s0, valid, bound, a.c, n, a.nr);
    write_row(a.rows + (size_t)(r * a.W) * NK, kadv, madv, MW, cme, MCX, s0,
              valid);
    // the closure successor: every pure candidate at once
    unsigned mc[MAXW], mcl[MAXW];
    for (int w = 0; w < MW; ++w) mc[w] = me[w] | pb[w];
    const int tc = trailing_ones(mc, MW);
    shr_by(mc, tc, mcl, MW);
    int kcl = ke + tc, scl = se;
    fast_forward(kcl, scl, closure_ok, bound, a.c, n, a.nr);
    write_row(a.rows + (size_t)(grid_rows + r) * NK, kcl, mcl, MW, cme, MCX,
              scl, closure_ok);
  } else if (t < a.W) {
    unsigned m2[MAXW];
    for (int w = 0; w < MAXW; ++w) m2[w] = me[w];
    m2[t >> 5] |= 1u << (t & 31);
    write_row(a.rows + (size_t)(r * a.W + t) * NK, ke, m2, MW, cme, MCX, s2,
              valid);
  }

  // the [E, CR] crashed grid with the canonical-order prune: crash t
  if (t < a.CR) {
    const int c = t, cp = a.c.cps[c];
    const int prevc = clampi(cp, 0, a.CR - 1);
    const bool redundant =
        cp >= 0 && a.c.cinv[prevc] < retk && !bit(cme, prevc);
    const bool ccand = ae && !closure_ok && a.c.cinv[c] < retk &&
                       !bit(cme, c) && !redundant;
    bool cok;
    const int cs2 = cas_step(se, a.c.cf[c], a.c.cv1[c], a.c.cv2[c], cok);
    unsigned ccm[MAXW];
    for (int w = 0; w < MAXW; ++w) ccm[w] = cme[w];
    ccm[c >> 5] |= 1u << (c & 31);
    write_row(a.rows + (size_t)(grid_rows + a.E + r * a.CR + c) * NK, ke, me,
              MW, ccm, MCX, cs2, ccand && cok && cs2 != se);
  }
}

// ---------------------------------------------------------------------------
// K2 sort_rows (B5, lex; tpu.py:574-588). Bitonic sort of the RP rows on the
// whole row, mask words compared unsigned. Rows whose keys are all equal are
// identical, so the unstable network gives the reference's order. Stages
// with partner distance below S = min(RP, 1024) rows run in shared memory
// (S * NK * 4 <= 48 KB); longer distances take one global pass each. At
// R = 512 the whole sort is one block; at RP = 2^17 it is 36 launches and
// the global passes' bytes bound it.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool row_less(const int* x, const int* y, int NK,
                                         int MW) {
  for (int w = 0; w < NK; ++w) {
    const int a = x[w], b = y[w];
    if (a != b) {
      const bool uns = (w >= 2 && w < 2 + MW) || w >= 4 + MW;
      return uns ? (unsigned)a < (unsigned)b : a < b;
    }
  }
  return false;
}

__device__ __forceinline__ void cmp_swap(int* x, int* y, int NK, int MW,
                                         bool asc) {
  if (asc ? row_less(y, x, NK, MW) : row_less(x, y, NK, MW)) {
    for (int w = 0; w < NK; ++w) {
      const int tmp = x[w];
      x[w] = y[w];
      y[w] = tmp;
    }
  }
}

__global__ void sort_local_kernel(int* rows, const int* scal, int NK, int MW,
                                  int S, int k_first, int k_last) {
  if (scal[ACT] == 0) return;
  extern __shared__ int sh[];
  const size_t base = (size_t)blockIdx.x * S;
  for (int i = threadIdx.x; i < S * NK; i += blockDim.x)
    sh[i] = rows[base * NK + i];
  __syncthreads();
  for (int kk = k_first; kk <= k_last; kk <<= 1) {
    for (int j = min(kk >> 1, S >> 1); j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < S / 2; p += blockDim.x) {
        const int i = (p / j) * 2 * j + (p % j);
        cmp_swap(sh + i * NK, sh + (i + j) * NK, NK, MW,
                 ((base + i) & (size_t)kk) == 0);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < S * NK; i += blockDim.x)
    rows[base * NK + i] = sh[i];
}

__global__ void sort_global_kernel(int* rows, const int* scal, int RP, int NK,
                                   int MW, int kk, int j) {
  if (scal[ACT] == 0) return;
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (size_t)(RP / 2)) return;
  const size_t i = (p / j) * 2 * j + (p % j);
  cmp_swap(rows + i * NK, rows + (i + j) * NK, NK, MW,
           (i & (size_t)kk) == 0);
}

// ---------------------------------------------------------------------------
// K3 group_scan (B6; tpu.py:605): g[i] = cummax(same_grp[i] ? 0 : i), the
// index of row i's group start. A warp-shuffle max-scan per 1024-row block,
// then, beyond one block, a second launch adds the carry of the blocks
// before. Reads (3 + MW) words a row; bytes-bound on the wide rungs.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool same_grp(const int* rows, int i, int NK,
                                         int MW) {
  if (i == 0) return false;
  const int* x = rows + (size_t)i * NK;
  const int* y = x - NK;
  if (x[0] > MAXK || y[0] > MAXK) return false;
  for (int w = 0; w < 3 + MW; ++w)
    if (x[w] != y[w]) return false;
  return true;
}

__global__ void __launch_bounds__(1024)
    scan_local_kernel(const int* rows, const int* scal, int* g, int* gagg,
                      int RP, int NK, int MW) {
  if (scal[ACT] == 0) return;
  __shared__ int wmax[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int i = blockIdx.x * blockDim.x + t;
  int v = (i < RP && !same_grp(rows, i, NK, MW)) ? i : 0;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = max(v, y);
  }
  if (lane == 31) wmax[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? wmax[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w = max(w, y);
    }
    wmax[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = max(v, wmax[warp - 1]);
  if (i < RP) g[i] = v;
  if (t == (int)blockDim.x - 1) gagg[blockIdx.x] = v;
}

__global__ void scan_carry_kernel(const int* scal, int* g, const int* gagg,
                                  int RP) {
  if (scal[ACT] == 0) return;
  __shared__ int carry;
  const int b = blockIdx.x + 1;
  if (threadIdx.x == 0) {
    int c = 0;
    for (int q = 0; q < b; ++q) c = max(c, gagg[q]);
    carry = c;
  }
  __syncthreads();
  const int i = b * blockDim.x + threadIdx.x;
  if (i < RP) g[i] = max(g[i], carry);
}

// ---------------------------------------------------------------------------
// K4 dedup_truncate (B6-B7; tpu.py:589-664). One thread per row: the
// adjacent-duplicate test, the 8-leader subset-dominance test from the
// group start, and the first-C truncation into the other pool buffer. Warp
// reductions feed the level's accumulators; the last block to finish (a
// ticket) writes the stats row and the scalars and zeroes the accumulators.
// While the search is inactive it copies the pool through unchanged.
// ---------------------------------------------------------------------------

struct DedupArgs {
  const int* rows;
  const int* g;
  PoolIn pin;
  PoolOut pout;
  int* pk;
  int* ps;
  uint8_t* pa;
  int* scal;
  int* acc;
  int* stats;
  int C, MW, MCX, NK, CR, R, nr, lmax;
};

__global__ void __launch_bounds__(256) dedup_kernel(DedupArgs a) {
  const int t = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + t;
  const int MW = a.MW, MCX = a.MCX, NK = a.NK;
  if (a.scal[ACT] == 0) {
    if (i < a.C) {
      a.pout.k[i] = a.pin.k[i];
      for (int w = 0; w < MW; ++w) a.pout.mask[i * MW + w] = a.pin.mask[i * MW + w];
      for (int w = 0; w < MCX; ++w)
        a.pout.cmask[i * MCX + w] = a.pin.cmask[i * MCX + w];
      a.pout.state[i] = a.pin.state[i];
      a.pout.alive[i] = a.pin.alive[i];
    }
    return;
  }

  bool fv = false, dup = false, dom = false, uniq = false;
  int fk = 0;
  if (i < a.R) {
    const int* ri = a.rows + (size_t)i * NK;
    fv = ri[0] <= MAXK;
    fk = ri[1];
    bool cm_eq = i > 0;
    for (int w = 0; w < MCX && cm_eq; ++w)
      cm_eq = ri[4 + MW + w] == ri[4 + MW + w - NK];
    dup = cm_eq && same_grp(a.rows, i, NK, MW);
    if (a.CR > 0 && fv) {
      const int gi = a.g[i];
      for (int p = 0; p < LEADERS && !dom; ++p) {
        const int li = min(gi + p, a.R - 1);
        if (li >= i) break;
        const int* rl = a.rows + (size_t)li * NK;
        bool lead = true;
        for (int w = 0; w < 3 + MW && lead; ++w) lead = rl[w] == ri[w];
        bool subset = true;
        for (int w = 0; w < MCX && subset; ++w) {
          const unsigned cl = rl[4 + MW + w], ci = ri[4 + MW + w];
          subset = (ci & cl) == cl;
        }
        dom = lead && subset;
      }
    }
    uniq = fv && !dup && !dom;
  }
  if (i < a.C) {
    const int* ri = a.rows + (size_t)i * NK;
    a.pout.k[i] = ri[1];
    for (int w = 0; w < MW; ++w) a.pout.mask[i * MW + w] = (unsigned)ri[2 + w];
    for (int w = 0; w < MCX; ++w)
      a.pout.cmask[i * MCX + w] = (unsigned)ri[4 + MW + w];
    a.pout.state[i] = ri[2 + MW];
    a.pout.alive[i] = uniq;
    a.pk[i] = a.pin.k[i];
    a.ps[i] = a.pin.state[i];
    a.pa[i] = a.pin.alive[i];
  }

  const bool kept = i < a.C && uniq, lost = i >= a.C && uniq;
  const unsigned done_any = __reduce_or_sync(FULL, fv && fk >= a.nr);
  const int best = __reduce_max_sync(FULL, fv ? fk : 0);
  const unsigned ndup = __reduce_add_sync(FULL, dup);
  const unsigned ndom = __reduce_add_sync(FULL, dom);
  const unsigned nlost = __reduce_add_sync(FULL, lost);
  const unsigned nkept = __reduce_add_sync(FULL, kept);
  if ((t & 31) == 0) {
    if (done_any) atomicOr(&a.acc[A_DONE], 1);
    if (nlost) atomicOr(&a.acc[A_LOSSY], 1);
    atomicMax(&a.acc[A_BEST], best);
    if (ndup) atomicAdd(&a.acc[A_DUP], (int)ndup);
    if (ndom) atomicAdd(&a.acc[A_DOM], (int)ndom);
    if (nlost) atomicAdd(&a.acc[A_TRUNC], (int)nlost);
    if (nkept) atomicAdd(&a.acc[A_FRONTIER], (int)nkept);
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (t == 0) last = atomicAdd(&a.acc[A_TICKET], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (last && t == 0) {
    __threadfence();
    volatile int* acc = a.acc;
    const int level = a.scal[LEVEL];
    int* srow = a.stats + (size_t)clampi(level, 0, a.lmax) * NSTAT;
    srow[0] = acc[A_EXPANDED];
    srow[1] = acc[A_DUP];
    srow[2] = acc[A_DOM];
    srow[3] = acc[A_TRUNC];
    srow[4] = acc[A_FRONTIER];
    a.scal[DONE] |= acc[A_DONE];
    a.scal[LOSSY] |= acc[A_LOSSY];
    a.scal[LEVEL] = level + 1;
    a.scal[BEST] = max(a.scal[BEST], (int)acc[A_BEST]);
    a.scal[NALIVE] = acc[A_FRONTIER];
    for (int q = 0; q < NACC; ++q) acc[q] = 0;
  }
}

int padded_rows(int R) {
  int RP = 2;
  while (RP < R) RP <<= 1;
  return RP;
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int jt_expand(const int* f, const int* v1, const int* v2, const int* ro,
              const int* fr, const int* inv, const int* ret, const int* sm,
              const int* cf, const int* cv1, const int* cv2, const int* cinv,
              const int* cps, const int* k, const unsigned* mask,
              const unsigned* cmask, const int* state, const uint8_t* alive,
              int* scal, int* acc, int* rows, int C, int W, int E, int n,
              int CR, int nr, int lmax, void* stream) {
  ExpandArgs a;
  a.c = Cols{f, v1, v2, ro, fr, inv, ret, sm, cf, cv1, cv2, cinv, cps};
  a.pool = PoolIn{k, mask, cmask, state, alive};
  a.scal = scal;
  a.acc = acc;
  a.rows = rows;
  a.C = C;
  a.W = W;
  a.E = E;
  a.n = n;
  a.CR = CR;
  a.MW = (W + 31) / 32;
  a.MCX = CR > 32 ? (CR + 31) / 32 : 1;
  a.NK = 4 + a.MW + a.MCX;
  a.R = E * (W + 1 + CR) + (C - E);
  a.RP = padded_rows(a.R);
  a.nr = nr;
  a.lmax = lmax;
  const int tail = (C - E) + (a.RP - a.R);
  const int blocks = E + (tail + 127) / 128;
  expand_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int jt_sort_rows(int* rows, const int* scal, int RP, int NK, int MW,
                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int S = RP < 1024 ? RP : 1024;
  const size_t smem = (size_t)S * NK * sizeof(int);
  sort_local_kernel<<<RP / S, S / 2, smem, st>>>(rows, scal, NK, MW, S, 2, S);
  for (int kk = 2 * S; kk <= RP; kk <<= 1) {
    for (int j = kk >> 1; j >= S; j >>= 1)
      sort_global_kernel<<<(RP / 2 + 255) / 256, 256, 0, st>>>(rows, scal, RP,
                                                               NK, MW, kk, j);
    sort_local_kernel<<<RP / S, S / 2, smem, st>>>(rows, scal, NK, MW, S, kk,
                                                   kk);
  }
  return (int)cudaGetLastError();
}

int jt_group_scan(const int* rows, const int* scal, int* g, int* gagg, int RP,
                  int NK, int MW, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = RP < 1024 ? (RP < 32 ? 32 : RP) : 1024;
  const int blocks = RP < 1024 ? 1 : RP / 1024;
  scan_local_kernel<<<blocks, threads, 0, st>>>(rows, scal, g, gagg, RP, NK,
                                                MW);
  if (blocks > 1)
    scan_carry_kernel<<<blocks - 1, threads, 0, st>>>(scal, g, gagg, RP);
  return (int)cudaGetLastError();
}

int jt_dedup_truncate(const int* rows, const int* g, const int* in_k,
                      const unsigned* in_mask, const unsigned* in_cmask,
                      const int* in_state, const uint8_t* in_alive,
                      int* out_k, unsigned* out_mask, unsigned* out_cmask,
                      int* out_state, uint8_t* out_alive, int* pk, int* ps,
                      uint8_t* pa, int* scal, int* acc, int* stats, int C,
                      int W, int CR, int R, int nr, int lmax, void* stream) {
  DedupArgs a;
  a.rows = rows;
  a.g = g;
  a.pin = PoolIn{in_k, in_mask, in_cmask, in_state, in_alive};
  a.pout = PoolOut{out_k, out_mask, out_cmask, out_state, out_alive};
  a.pk = pk;
  a.ps = ps;
  a.pa = pa;
  a.scal = scal;
  a.acc = acc;
  a.stats = stats;
  a.C = C;
  a.MW = (W + 31) / 32;
  a.MCX = CR > 32 ? (CR + 31) / 32 : 1;
  a.NK = 4 + a.MW + a.MCX;
  a.CR = CR;
  a.R = R;
  a.nr = nr;
  a.lmax = lmax;
  dedup_kernel<<<(R + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
