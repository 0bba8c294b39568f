// One level of the pool linearizability search, as kernels for Hopper: K1
// expand, K2 sort_rows, K3 group_scan (a launch of its own only on the
// wide rungs of a search with crashed ops; in K4 on the narrow ones) and
// K4 dedup_truncate; K5 seg_active ends a segment's level pair (in the
// pair's second K4 inside the segment graph).
//
// Replaces the XLA program that jax.jit compiles from the search body
// _search_fn in jepsen_tpu/checker/tpu.py (rows B1-B7 of the device-program
// table in PERF.md). The plain PyTorch version of every kernel sits beside its
// wrapper in jepsen_tpu_torch/kernels/search.py; the two agree bit for bit.
//
// Every buffer has a leading key axis of B independent searches (the keyed
// batch; the single-history search is B = 1), and every kernel takes the key
// from blockIdx.y. Per key (all int32; mask words hold uint32 bit patterns):
//   cols   f, v1, v2, ro, fr, inv, ret [n], sm [n+1], cf, cv1, cv2, cinv,
//          cps, cb [CR], nr (the required-op count, one int per key)
//   pool   k[C], mask[C][MW], cmask[C][MCX], state[C], alive[C] (uint8)
//   row    key1, k, mask[MW], state, popcount(cmask), cmask[MCX]  (NK words)
//   scal   done, lossy, wovf, level, best_k, live rows, active, spare
//   acc    per-level sums: done, best, lossy, expanded, dup, dominated,
//          trunc, frontier, block ticket; zero between levels
// Each key keeps its own `active` flag, so a finished key's levels are
// no-ops while the others go on (the vmapped masked update, tpu.py:652).
// K1 is a template on the model: its step is a device function below, and
// the host entry picks the instantiation once per launch.
//
// The level is launch-bound at the single-history headline rung (R = 512
// rows: a few microseconds of work per kernel) and bound by the sort on the
// wide rungs (R up to ~1M rows); the key axis gives each kernel B
// times the blocks, which fills the 132 SMs on a keyed batch. Nothing
// synchronises with the host, and the `active` flags are read on the device.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (jepsen_tpu_torch/kernels/build.py). Plain C
// interface; every entry point adds each kernel launch it makes to
// *launched and returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

// The segment loop (B9) is a CUDA graph with a WHILE conditional node
// whose condition K5's step sets on the device: CUDA 12.3 or later.
#if CUDART_VERSION < 12030
#error "the segment graph's WHILE node needs CUDA 12.3 or later"
#endif

namespace {

constexpr int MAXK = 1 << 30;
constexpr int RET_INF = 0x7fffffff;
constexpr int PAD_KEY = 0x7fffffff;
constexpr int LEADERS = 8;
constexpr int NSTAT = 5;
constexpr int MAXW = 4;  // mask words: windows and crashed sets up to 128
constexpr unsigned FULL = 0xffffffffu;

enum { DONE, LOSSY, WOVF, LEVEL, BEST, NALIVE, ACT, SPARE, NSCAL };
enum { A_DONE, A_BEST, A_LOSSY, A_EXPANDED, A_DUP, A_DOM, A_TRUNC,
       A_FRONTIER, A_TICKET, NACC };
enum { TB_LEX, TB_HASH };

struct Cols {
  const int *f, *v1, *v2, *ro, *fr, *inv, *ret, *sm, *cf, *cv1, *cv2, *cinv,
      *cps, *cb;
};

// Key b's columns: [B, n] required, [B, n + 1] sm, [B, CR] crashed.
__device__ __forceinline__ Cols cols_at(const Cols& c, int b, int n, int CR) {
  const size_t q = (size_t)b * n, cq = (size_t)b * CR;
  return Cols{c.f + q,     c.v1 + q,   c.v2 + q,   c.ro + q,
              c.fr + q,    c.inv + q,  c.ret + q,  c.sm + (size_t)b * (n + 1),
              c.cf + cq,   c.cv1 + cq, c.cv2 + cq, c.cinv + cq,
              c.cps + cq,  c.cb + cq};
}

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

// Key b's pool: [B, C], [B, C, MW] and [B, C, MCX].
__device__ __forceinline__ PoolIn pool_at(const PoolIn& p, int b, int C,
                                          int MW, int MCX) {
  const size_t q = (size_t)b * C;
  return PoolIn{p.k + q, p.mask + q * MW, p.cmask + q * MCX, p.state + q,
                p.alive + q};
}

__device__ __forceinline__ PoolOut pool_at(const PoolOut& p, int b, int C,
                                           int MW, int MCX) {
  const size_t q = (size_t)b * C;
  return PoolOut{p.k + q, p.mask + q * MW, p.cmask + q * MCX, p.state + q,
                 p.alive + q};
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// B1, B1': the model steps (jepsen_tpu/models/core.py:375-834), one per
// model, each returning state' and setting ok. They equal the reference's
// branchless int32 arithmetic on every input, state' where ok is false
// included (the rows sort on it): sums and left shifts go through unsigned,
// right shifts of the signed word are arithmetic, and a shift of 32 or more
// gives what XLA gives (0 left; the sign right).
enum { M_CAS, M_MUTEX, M_NOOP, M_SET, M_UQUEUE, M_FIFO, NMODELS };
enum { F_READ, F_WRITE, F_CAS, F_ACQUIRE, F_RELEASE, F_ADD, F_ENQUEUE,
       F_DEQUEUE };
constexpr int NIL_ID = -1;

// B1: the CAS register (models/core.py:375).
__device__ __forceinline__ int cas_step(int s, int f, int v1, int v2,
                                        bool& ok) {
  const bool cas_ok = s == v1;
  const bool is_write = f == F_WRITE;
  const bool take_cas = f == F_CAS && cas_ok;
  ok = (f == F_READ && (v1 == NIL_ID || cas_ok)) || is_write || take_cas;
  return take_cas ? v2 : (is_write ? v1 : s);
}

// The mutex (models/core.py:389): 1 is locked.
__device__ __forceinline__ int mutex_step(int s, int f, int, int,
                                          bool& ok) {
  const bool acq = f == F_ACQUIRE, rel = f == F_RELEASE;
  ok = (acq && s == 0) || (rel && s == 1);
  return acq ? 1 : (rel ? 0 : s);
}

// The no-op model (models/core.py:398): every op succeeds, padding included.
__device__ __forceinline__ int noop_step(int s, int, int, int, bool& ok) {
  ok = true;
  return s;
}

// The grow-only set (models/core.py:424): an add's v1 is a unit word, v2 == 1
// selects count mode (+), anything else OR mode; a read succeeds on an
// exact target word, or on NIL_ID.
__device__ __forceinline__ int set_step(int s, int f, int v1, int v2,
                                        bool& ok) {
  const bool add = f == F_ADD;
  ok = add || (f == F_READ && (v1 == NIL_ID || s == v1));
  const int unit = add && v1 >= 0 ? v1 : 0;
  return add && v2 == 1 ? (int)((unsigned)s + (unsigned)unit) : s | unit;
}

// The unordered queue (models/core.py:591): v1 is a field's bit offset, v2
// its count mask; v2 == 0 is a sink enqueue, which changes nothing. A
// dequeue needs a count above 0.
__device__ __forceinline__ int uqueue_step(int s, int f, int v1, int v2,
                                           bool& ok) {
  const bool enq = f == F_ENQUEUE, deq = f == F_DEQUEUE;
  const int sh = v1 >= 0 ? v1 : 0;
  const unsigned unit = sh < 32 ? 1u << sh : 0u;
  const int cnt = (s >> (sh < 32 ? sh : 31)) & v2;
  const bool deq_ok = deq && v1 >= 0 && cnt > 0;
  ok = enq || deq_ok;
  unsigned r = (unsigned)s;
  if (enq && v2 > 0) r += unit;
  if (deq_ok) r -= unit;
  return (int)r;
}

// The FIFO queue (models/core.py:814): a ring of seven 4-bit ids, nibble 0
// the head, id 0 empty. Its length is the count of nonzero nibbles: one
// popcount of the per-nibble occupancy bits.
__device__ __forceinline__ int fifo_step(int s, int f, int v1, int,
                                         bool& ok) {
  const int occ = s | (s >> 1) | (s >> 2) | (s >> 3);
  const int len = __popc((unsigned)occ & 0x1111111u);
  const bool enq_ok = f == F_ENQUEUE && len < 7;
  const bool deq_ok = f == F_DEQUEUE && v1 > 0 && (s & 15) == v1;
  ok = enq_ok || deq_ok;
  if (enq_ok) return s | (int)((unsigned)v1 << (4 * len));
  return deq_ok ? s >> 4 : s;
}

template <int M>
__device__ __forceinline__ int model_step(int s, int f, int v1, int v2,
                                          bool& ok) {
  if constexpr (M == M_MUTEX) return mutex_step(s, f, v1, v2, ok);
  else if constexpr (M == M_NOOP) return noop_step(s, f, v1, v2, ok);
  else if constexpr (M == M_SET) return set_step(s, f, v1, v2, ok);
  else if constexpr (M == M_UQUEUE) return uqueue_step(s, f, v1, v2, ok);
  else if constexpr (M == M_FIFO) return fifo_step(s, f, v1, v2, ok);
  else return cas_step(s, f, v1, v2, ok);
}

// B2: whole-mask bit helpers (tpu.py:122-161) over MAXW words held in
// registers: every loop is unrolled to MAXW with static indices, and the
// words past a mask's MW are zero, which gives what MW words give.
__device__ __forceinline__ unsigned word_at(const unsigned* m, int i) {
  unsigned v = 0u;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) v = w == i ? m[w] : v;
  return v;
}

__device__ __forceinline__ bool bit(const unsigned* m, int o) {
  return (word_at(m, o >> 5) >> (o & 31)) & 1u;
}

__device__ __forceinline__ int trailing_ones(const unsigned* m) {
  int t = 0;
  bool more = true;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    const unsigned z = ~m[w];
    const int tw = z ? __ffs(z) - 1 : 32;
    t += more ? tw : 0;
    more = more && tw == 32;
  }
  return t;
}

__device__ __forceinline__ void shr1(const unsigned* m, unsigned* out) {
#pragma unroll
  for (int w = 0; w < MAXW; ++w)
    out[w] = (m[w] >> 1) | (w + 1 < MAXW ? m[w + 1] << 31 : 0u);
}

__device__ __forceinline__ void shr_by(const unsigned* m, int t,
                                       unsigned* out) {
  const int ws = t >> 5, bs = t & 31;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    const unsigned a = word_at(m, w + ws), b = word_at(m, w + ws + 1);
    out[w] = (a >> bs) | (bs ? b << (32 - bs) : 0u);
  }
}

// A sortable row (NK words) from its configuration; row may be in shared
// memory.
__device__ __forceinline__ void write_row(int* row, int k, const unsigned* m,
                                          int MW, const unsigned* cm,
                                          int MCX, int s, bool valid) {
  int pm = 0, pc = 0;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    pm += __popc(m[w]);
    pc += __popc(cm[w]);
  }
  row[0] = valid ? MAXK - (k + pm) : MAXK + 1 + k;
  row[1] = k;
#pragma unroll
  for (int w = 0; w < MAXW; ++w)
    if (w < MW) row[2 + w] = (int)m[w];
  row[2 + MW] = s;
  row[3 + MW] = pc;
#pragma unroll
  for (int w = 0; w < MAXW; ++w)
    if (w < MCX) row[4 + MW + w] = (int)cm[w];
}

// ---------------------------------------------------------------------------
// K1 expand (B1-B4; tpu.py:377-506, the forced fast-forward :294-346).
// Replaces the expansion of _search_fn's level body: the [E, W] required
// grid through the model step, the pure-op closure, the frontier advance
// with its forced fast-forward, the [E, CR] crashed grid with the
// canonical-order prune, and the pool remainder, as R sortable rows.
//
// What bounds it. Not bytes (the headline's level moves ~25 KB) and not
// operations (E (W + CR) model steps): latency. At the narrow rungs a few
// blocks run, and the time is the launch plus the longest chain of
// dependent loads: the row's pool entry, its window's columns, then a
// forced run's columns step after step; a crash bound found by binary
// search over ret would add 13 dependent loads at n = 8,192.
//
// Design: a warp per expanded row, EXPAND_WARPS rows a block.
//   One dependent hop. Hop 0 reads the key's flags, the pool row and the
//   crashed ops' columns (lane l holds crashed op 32 w + l); hop 1 reads
//   ret[k], sm[k + W] and, one coalesced pass per column, f, v1, v2, fr
//   over [k, k + W + 32) (chunk q: lane l holds position k + 32 q + l)
//   and ro, inv over the window. Candidate o = 32 q + l is lane l's; one ballot per 32
//   candidates is the closure's pure word, so no shared memory or block
//   barrier stands between the candidates and the closure.
//   The crash bound without a search: searchsorted(ret, ., right) is
//   monotone, so searchsorted(ret, min over untaken cinv) = min(n, min over
//   untaken cb), cb[i] = searchsorted(ret, cinv[i], right) a column of the
//   history (checker/gpu.py crash_bounds; n on padded slots): one warp
//   min over the lanes' crashed ops.
//   One forced run per row. valid at offset 0 is false where the closure
//   holds, so at most one of the two successors fast-forwards. The warp
//   walks it together: the steps' operands come from the preloaded chunks
//   by __shfl_sync, RUN_STEP positions' at a time ahead of their steps
//   (they do not depend on the state), one ballot a chunk gives the
//   state-free part of the test (fr > 0, k < bound, k < nr), and past the
//   preloaded chunks the warp reads 32 positions at a time, the next
//   chunk's loads issued when the walk enters a chunk; so a run as long
//   as the history costs about one step's dependent arithmetic a
//   position.
//   Coalesced stores. A row's W required rows (r W + o) and its CR crashed
//   rows are contiguous: each lane builds its rows in the warp's part of
//   shared memory and the warp stores them as consecutive words. The
//   expanded and window-overflow flags are summed per block before one
//   atomic each. Blocks past the expanding ones write the pool remainder
//   and the sort's pad rows the same way, two rows a thread.
// Grid (ceil(E / EXPAND_WARPS) + tail blocks, B); a key whose search is
// inactive writes nothing. Template parameter M is the model; jt_expand
// instantiates one per model and picks it per launch.
// ---------------------------------------------------------------------------

constexpr int EXPAND_WARPS = 4;             // expanded rows a block
constexpr int NK_MAX = 4 + 2 * MAXW;        // the widest row
constexpr int CHUNKS = MAXW + 1;            // window chunks and one beyond
constexpr int STAGE_WORDS = (32 * MAXW + 1) * NK_MAX;  // a warp's rows
constexpr int TAIL_ROWS = 64 * EXPAND_WARPS;  // rows a tail block writes
constexpr int RUN_STEP = 8;                 // forced steps a shuffle batch

struct ExpandArgs {
  Cols c;
  PoolIn pool;
  const int* nr;
  int* scal;
  int* acc;
  int* rows;
  int C, W, E, n, CR, MW, MCX, NK, R, RP, lmax;
};

// Warp-cooperative copy of `words` consecutive words from shared memory.
__device__ __forceinline__ void store_words(int* dst, const int* src,
                                            int words, int lane) {
  for (int w = lane; w < words; w += 32) dst[w] = src[w];
}

// Rows from R0 = E (W + 1 + CR) on: the unexpanded pool remainder, then
// the sort's pad rows (key1 = PAD_KEY, the rest 0). A tail block writes
// TAIL_ROWS of them, two rows a thread, through shared memory.
__device__ void expand_tail(const ExpandArgs& a, const PoolIn& pool,
                            bool act, int* rows, int* stage, int tail) {
  const int MW = a.MW, MCX = a.MCX, NK = a.NK, t = threadIdx.x;
  const int R0 = a.E * (a.W + 1 + a.CR), first = R0 + tail * TAIL_ROWS;
  const int cnt = min(TAIL_ROWS, a.RP - first);
  for (int j = t; j < cnt; j += blockDim.x) {
    const int i = first + j;
    int* row = stage + j * NK;
    if (i < a.R) {
      const int p = a.E + (i - R0);
      unsigned m[MAXW], cm[MAXW];
#pragma unroll
      for (int w = 0; w < MAXW; ++w) {
        m[w] = w < MW ? pool.mask[p * MW + w] : 0u;
        cm[w] = w < MCX ? pool.cmask[p * MCX + w] : 0u;
      }
      write_row(row, pool.k[p], m, MW, cm, MCX, pool.state[p],
                pool.alive[p] != 0);
    } else {
      row[0] = PAD_KEY;
      for (int w = 1; w < NK; ++w) row[w] = 0;
    }
  }
  if (!act) return;
  __syncthreads();
  int* dst = rows + (size_t)first * NK;
  for (int w = t; w < cnt * NK; w += blockDim.x) dst[w] = stage[w];
}

// The forced run from position kk in state ss, by the whole warp (kk, ss
// warp-uniform): advance while fr > 0, kk < bound, kk < nr and the step
// succeeds (tpu.py:308-346). Chunk q of the preloaded columns holds
// positions ke + 32 q + lane; kk - ke lies in [0, W] at the start.
template <int M>
__device__ __forceinline__ void forced_run(
    int& kk, int& ss, int ke, int bound, int nr, int MW, const Cols& c,
    int n, const int (&pf)[CHUNKS], const int (&pv1)[CHUNKS],
    const int (&pv2)[CHUNKS], const int (&pfr)[CHUNKS], int lane) {
  int q = (kk - ke) >> 5, base = ke + 32 * q;
  int cf = 0, cv1 = 0, cv2 = 0, cfr = 0;    // the current chunk
  int nf = 0, nv1 = 0, nv2 = 0, nfr = 0;    // the next, once past them
  auto enter = [&]() {
    if (q <= MW) {
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i)
        if (i == q) {
          cf = pf[i];
          cv1 = pv1[i];
          cv2 = pv2[i];
          cfr = pfr[i];
        }
    } else {
      cf = nf;
      cv1 = nv1;
      cv2 = nv2;
      cfr = nfr;
    }
    if (q >= MW) {  // the chunk after this one comes from device memory
      const int jc = clampi(base + 32 + lane, 0, n - 1);
      nf = c.f[jc];
      nv1 = c.v1[jc];
      nv2 = c.v2[jc];
      nfr = c.fr[jc];
    }
    const int p = base + lane;
    return __ballot_sync(FULL, cfr > 0 && p < bound && p < nr);
  };
  unsigned sgo = enter();
  for (;;) {
    const int li = kk - base;
    if (li == 32) {
      q += 1;
      base += 32;
      sgo = enter();
      continue;
    }
    // positions li .. li + RUN_STEP - 1 of the chunk: their operands by
    // shuffles, which do not wait on the state, then the dependent steps
    int f[RUN_STEP], v1[RUN_STEP], v2[RUN_STEP];
#pragma unroll
    for (int j = 0; j < RUN_STEP; ++j) {
      const int src = min(li + j, 31);
      f[j] = __shfl_sync(FULL, cf, src);
      v1[j] = __shfl_sync(FULL, cv1, src);
      v2[j] = __shfl_sync(FULL, cv2, src);
    }
    bool go = true;
#pragma unroll
    for (int j = 0; j < RUN_STEP; ++j) {
      const int i = li + j;
      bool ok;
      const int s2 = model_step<M>(ss, f[j], v1[j], v2[j], ok);
      go = go && i < 32 && ((sgo >> (i & 31)) & 1u) && ok;
      if (go) {
        kk += 1;
        ss = s2;
      }
    }
    if (!go && kk - base < 32) break;   // stopped inside the chunk
  }
}

// Expanded row r of key b, by one warp into its stage; returns (to every
// lane) whether the row was alive, and sets wovf where its window
// overflows. An inactive key (act false, known after the row's first
// loads are issued) returns at once and writes nothing.
template <int M>
__device__ bool expand_row(const ExpandArgs& a, int b, int r, int lane,
                           bool act, int* st, int* rows, bool& wovf) {
  const int MW = a.MW, MCX = a.MCX, NK = a.NK, n = a.n, W = a.W, CR = a.CR;
  const Cols c = cols_at(a.c, b, n, CR);
  const PoolIn pool = pool_at(a.pool, b, a.C, MW, MCX);
  const int nr = a.nr[b];

  // hop 0: the row (every lane), the crashed ops (lane l: 32 w + l)
  const int ke = pool.k[r];
  const bool ae = pool.alive[r] != 0;
  const int se = pool.state[r];
  unsigned me[MAXW], cme[MAXW];
  int xf[MAXW], xv1[MAXW], xv2[MAXW], xinv[MAXW], xps[MAXW], xb[MAXW];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    me[w] = w < MW ? pool.mask[r * MW + w] : 0u;
    cme[w] = w < MCX ? pool.cmask[r * MCX + w] : 0u;
    const int ci = 32 * w + lane;
    const bool in = ci < CR;
    xf[w] = in ? c.cf[ci] : 0;
    xv1[w] = in ? c.cv1[ci] : 0;
    xv2[w] = in ? c.cv2[ci] : 0;
    xinv[w] = in ? c.cinv[ci] : RET_INF;
    xps[w] = in ? c.cps[ci] : -1;
    xb[w] = in ? c.cb[ci] : n;
  }
  if (!act) return false;

  // hop 1: ret, sm and the columns over [ke, ke + W + 32)
  const int retk = c.ret[clampi(ke, 0, n - 1)];
  const int smw = c.sm[clampi(ke + W, 0, n)];
  int pf[CHUNKS], pv1[CHUNKS], pv2[CHUNKS], pfr[CHUNKS];
  int pro[MAXW], pinv[MAXW];
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int jc = clampi(ke + 32 * q + lane, 0, n - 1);
    const bool in = q <= MW;
    pf[q] = in ? c.f[jc] : 0;
    pv1[q] = in ? c.v1[jc] : 0;
    pv2[q] = in ? c.v2[jc] : 0;
    pfr[q] = in ? c.fr[jc] : 0;
    if (q < MAXW) {
      pro[q] = q < MW ? c.ro[jc] : 0;
      pinv[q] = q < MW ? c.inv[jc] : 0;
    }
  }
  wovf = ae && smw < retk;

  // the [E, W] required grid: candidate 32 q + lane
  bool valid[MAXW];
  int s2[MAXW];
  unsigned pb[MAXW];
  bool any_pure = false;
#pragma unroll
  for (int q = 0; q < MAXW; ++q) {
    valid[q] = false;
    s2[q] = se;
    pb[q] = 0u;
    if (q < MW) {
      const int o = 32 * q + lane, j = ke + o;
      const bool cand = ae && o < W && j < n && pinv[q] < retk &&
                        !((me[q] >> lane) & 1u);
      bool ok;
      s2[q] = model_step<M>(se, pf[q], pv1[q], pv2[q], ok);
      const bool pure = cand && ok && pro[q] > 0;
      valid[q] = cand && ok && !pure;
      pb[q] = __ballot_sync(FULL, pure);
    }
    any_pure = any_pure || pb[q] != 0u;
  }
  const bool closure_ok = ae && any_pure;
#pragma unroll
  for (int q = 0; q < MAXW; ++q) valid[q] = valid[q] && !closure_ok;

  // the crash bound: min(n, min over untaken crashed ops of cb)
  int bound = n;
#pragma unroll
  for (int w = 0; w < MAXW; ++w)
    if (32 * w + lane < CR && !((cme[w] >> lane) & 1u))
      bound = min(bound, xb[w]);
  bound = __reduce_min_sync(FULL, bound);

  // offset 0: the frontier past linearized ops; the closure: every pure
  // candidate at once; then the one forced run of the two
  unsigned m1[MAXW], madv[MAXW], mc[MAXW], mcl[MAXW];
  shr1(me, m1);
  const int t1 = trailing_ones(m1);
  shr_by(m1, t1, madv);
#pragma unroll
  for (int w = 0; w < MAXW; ++w) mc[w] = me[w] | pb[w];
  const int tc = trailing_ones(mc);
  shr_by(mc, tc, mcl);
  const bool valid0 = __shfl_sync(FULL, (int)valid[0], 0) != 0;
  const int s0 = __shfl_sync(FULL, s2[0], 0);
  int kk = closure_ok ? ke + tc : ke + 1 + t1;
  int ss = closure_ok ? se : s0;
  if (closure_ok || valid0)
    forced_run<M>(kk, ss, ke, bound, nr, MW, c, n, pf, pv1, pv2, pfr, lane);

  // the W required rows and the closure row, staged, then stored; a lane
  // past W (W not a multiple of 32) has no candidate and stages no row
#pragma unroll
  for (int q = 0; q < MAXW; ++q) {
    const int o = 32 * q + lane;
    if (q < MW && o < W) {
      if (o == 0) {   // the run is the closure's where that holds
        write_row(st, closure_ok ? ke + 1 + t1 : kk, madv, MW, cme, MCX,
                  closure_ok ? s2[0] : ss, valid[0]);
      } else {
        unsigned m2[MAXW];
#pragma unroll
        for (int w = 0; w < MAXW; ++w)
          m2[w] = me[w] | (w == q ? 1u << lane : 0u);
        write_row(st + o * NK, ke, m2, MW, cme, MCX, s2[q], valid[q]);
      }
    }
  }
  if (lane == 0)
    write_row(st + W * NK, closure_ok ? kk : ke + tc, mcl, MW, cme, MCX,
              closure_ok ? ss : se, closure_ok);
  __syncwarp();
  store_words(rows + (size_t)r * W * NK, st, W * NK, lane);
  if (lane < NK) rows[((size_t)a.E * W + r) * NK + lane] = st[W * NK + lane];
  if (CR == 0) return ae;
  __syncwarp();

  // the [E, CR] crashed grid with the canonical-order prune: crashed op
  // ci = 32 w + lane; cinv[cps[ci]] comes from the lane that holds it
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    if (32 * w < CR) {
      const int ci = 32 * w + lane, cp = xps[w];
      const int prevc = clampi(cp, 0, CR - 1);
      int pinvc = 0;
#pragma unroll
      for (int v = 0; v < MAXW; ++v) {
        const int x = __shfl_sync(FULL, xinv[v], prevc & 31);
        pinvc = v == prevc >> 5 ? x : pinvc;
      }
      if (ci < CR) {
        const bool redundant = cp >= 0 && pinvc < retk && !bit(cme, prevc);
        const bool ccand = ae && !closure_ok && xinv[w] < retk &&
                           !((cme[w] >> lane) & 1u) && !redundant;
        bool cok;
        const int cs2 = model_step<M>(se, xf[w], xv1[w], xv2[w], cok);
        unsigned ccm[MAXW];
#pragma unroll
        for (int v = 0; v < MAXW; ++v)
          ccm[v] = cme[v] | (v == w ? 1u << lane : 0u);
        write_row(st + ci * NK, ke, me, MW, ccm, MCX, cs2,
                  ccand && cok && cs2 != se);
      }
    }
  }
  __syncwarp();
  store_words(rows + ((size_t)a.E * (W + 1) + (size_t)r * CR) * NK, st,
              CR * NK, lane);
  return ae;
}

template <int M>
__global__ void __launch_bounds__(32 * EXPAND_WARPS)
    expand_kernel(ExpandArgs a) {
  const int b = blockIdx.y;
  int* scal = a.scal + (size_t)b * NSCAL;
  const bool act =
      scal[DONE] == 0 && scal[NALIVE] > 0 && scal[LEVEL] <= a.lmax;
  if (blockIdx.x == 0 && threadIdx.x == 0) scal[ACT] = act;
  __shared__ int stage[EXPAND_WARPS * STAGE_WORDS];
  __shared__ int flags[EXPAND_WARPS];   // a warp's row: alive 1, wovf 2
  int* rows = a.rows + (size_t)b * a.RP * a.NK;
  const int blocks = (a.E + EXPAND_WARPS - 1) / EXPAND_WARPS;
  if ((int)blockIdx.x >= blocks) {
    expand_tail(a, pool_at(a.pool, b, a.C, a.MW, a.MCX), act, rows, stage,
                blockIdx.x - blocks);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * EXPAND_WARPS + warp;
  bool alive = false, wovf = false;
  if (r < a.E)
    alive = expand_row<M>(a, b, r, lane, act, stage + warp * STAGE_WORDS,
                          rows, wovf);
  if (!act) return;
  if (lane == 0) flags[warp] = (alive ? 1 : 0) | (wovf ? 2 : 0);
  __syncthreads();
  if (threadIdx.x == 0) {
    int expanded = 0, overflow = 0;
    for (int w = 0; w < EXPAND_WARPS; ++w) {
      expanded += flags[w] & 1;
      overflow |= flags[w] & 2;
    }
    int* acc = a.acc + (size_t)b * NACC;
    if (expanded) atomicAdd(&acc[A_EXPANDED], expanded);
    if (overflow) atomicOr(&scal[WOVF], 1);
  }
}

// ---------------------------------------------------------------------------
// K2 sort_rows (B5 lex, tpu.py:574-588; B5' hash, tpu.py:528-570): each
// active key's rows in the comparator's order. The tie-break is a template
// parameter of the comparator, row_less<TB>; the algorithm is the same.
//   lex:  the whole row in row order, mask words compared unsigned.
//   hash: key1, then h = a 32-bit mix of (k, mask, state) (unsigned), then
//         popcount(cmask), cmask, and last k, mask, state. The reference
//         sorts (key1, h[, pc, cmask]) with an index payload and gathers
//         the rows; the trailing row words make the order total, so any
//         correct sort and the plain version agree bit for bit. They
//         change the reference's order only where two distinct (k, mask,
//         state) share key1 and h, where its own order is unspecified.
// Rows whose words are all equal are identical, so the sort needs no
// stability: any correct sort gives the plain version's bytes.
//
// Only the R live rows are sorted. The RP - R rows after them are the pad
// rows K1's tail blocks write (expand_kernel: key1 = PAD_KEY, the rest 0),
// and a live row's key1 is at most MAXK + 1 + k < PAD_KEY (write_row), so
// under either tie-break every pad row orders after every live row: the
// pad tail already stands where a sort of all RP rows would put it.
//
// What bounds it. Neither bytes nor operations: the bound is microseconds
// below the time at every rung. On the narrow rungs (R <= T = 4,096: the
// single, keyed and gang states and every model's first rung) one block's
// latency: a key's sort is a few thousand row comparisons on one SM, and
// the time goes to the launch, the rows' way in and out (about 6 us of the
// headline's 16), and the chains of dependent shared-memory reads in the
// binary searches. On the wide rungs the one block that sorts each 4,096-
// row tile (its rounds' searches and merges, bound by instruction and
// shared-memory throughput at 512 threads), then the merge passes. The
// bitonic network this replaces swapped whole rows in 45 barrier stages
// at R = 512 and took 28 launches at R = 37,376.
//
// Design: a merge sort of 16-bit row slots in shared memory. A rank sort
// of the whole tile (O(R^2) comparisons) would cost a B = 256 batch ~10x
// the work, a bitonic network on slots still needs log2(R)^2 / 2 stages,
// and one merge routine (merge_slots) serves the tile and the wide passes.
//   Keys: a tile holds each row as its comparator's words in order,
//   unsigned (key_word, word_flip; under hash h is computed once per row
//   and kept as word 1), at an odd word stride (M | 1) so that a
//   warp reading neighbouring rows hits different banks. A comparison
//   (key_less) is then unsigned and lexicographic; its first two words
//   decide most of them, and the rest are read at once, unrolled to the
//   key's exact length: the host instantiates the kernels per key length.
//   Tile pass (sort_tile_kernel): one block per T rows of a key. The host
//   picks T (kernels/search.py tile_rows: the rows that 227 KB of shared
//   memory holds at the widest row, with two slot arrays) and the merge
//   passes; sort_rows_m checks that they cover R and that the device grants
//   the tile's shared memory. The rows come in once with 16-byte loads
//   and go out once, gathered through the final slots, with 16-byte
//   stores. Each thread sorts V slots (tile_v), then log2(n / V) rounds
//   merge runs pairwise between two slot arrays: a thread finds where its
//   V outputs start by a binary search on the merge path's diagonal and
//   merges them serially. Only slots move. A round whose pairs lie within
//   one warp waits for that warp only; wider rounds take a barrier.
//   Merge passes (sort_merge_kernel), when R > T: pass p merges pairs of
//   sorted runs of T * 2^p rows. A block takes MERGE_ROWS output rows: two
//   warps find its two ends on the pair's merge path by 32-way searches in
//   device memory (32-bit row offsets), the block loads the two input
//   ranges they bound (each contiguous), merges them as a tile round does,
//   and stores its rows: each pass reads and writes each live row once.
//   The passes ping-pong between rows and a second buffer, alt; the tile
//   pass writes to the one that makes the last pass land in rows, so no
//   copy follows. R <= T takes one launch, R > T 1 + ceil(log2(ceil(R /
//   T))); each launch is counted where it is made (jt_sort_rows' launched).
// Grid (blocks, B); a key whose active flag is clear is left untouched.
// ---------------------------------------------------------------------------

// B5': the reference's mix h of (k, mask, state), uint32 throughout.
__device__ __forceinline__ unsigned mix_hash(unsigned k, const int* mask,
                                             int MW, unsigned state) {
  unsigned h = k * 0x9E3779B9u;
  for (int w = 0; w < MW; ++w) {
    h = (h ^ (unsigned)mask[w]) * 0x85EBCA6Bu;
    h ^= h >> 13;
  }
  h = (h ^ state) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ unsigned row_hash(const int* row, int MW) {
  return mix_hash((unsigned)row[1], row + 2, MW, (unsigned)row[2 + MW]);
}

__device__ __forceinline__ bool word_less(int a, int b, int w, int MW) {
  const bool uns = (w >= 2 && w < 2 + MW) || w >= 4 + MW;
  return uns ? (unsigned)a < (unsigned)b : a < b;
}

template <int TB>
__device__ __forceinline__ bool row_less(const int* x, const int* y,
                                         unsigned hx, unsigned hy, int NK,
                                         int MW) {
  if (TB == TB_HASH) {
    if (x[0] != y[0]) return x[0] < y[0];
    if (hx != hy) return hx < hy;
    // pc, cmask[MCX], then k, mask[MW], state
    const int MCX1 = NK - 3 - MW;
    for (int i = 1; i < NK; ++i) {
      const int w = i <= MCX1 ? 2 + MW + i : i - MCX1;
      if (x[w] != y[w]) return word_less(x[w], y[w], w, MW);
    }
    return false;
  }
  for (int w = 0; w < NK; ++w)
    if (x[w] != y[w]) return word_less(x[w], y[w], w, MW);
  return false;
}

constexpr int MERGE_ROWS = 512;   // output rows of one merge-pass block
constexpr int MERGE_V = 2;        // outputs a merge-pass thread merges
constexpr unsigned SIGN = 0x80000000u;

// A row's key in a shared tile: its comparator's words in order (key1, then
// the row in row order under lex; key1, h, popcount(cmask), cmask, k, mask,
// state under hash), as unsigned words that order as the comparator does
// (signed words with bit 31 flipped): M = NK (lex) or NK + 1 (hash) words,
// at an odd stride (S = M | 1).

// Where row word c stands in the key, and its bit-31 flip.
template <int TB>
__device__ __forceinline__ int key_word(int c, int NK, int MW) {
  if (TB == TB_LEX) return c;
  const int MCX = NK - 4 - MW;
  return c == 0 ? 0 : c <= 2 + MW ? c + 2 + MCX : c == 3 + MW ? 2
                                                             : c - MW - 1;
}

__device__ __forceinline__ unsigned word_flip(int c, int MW) {
  return c <= 1 || c == 2 + MW || c == 3 + MW ? SIGN : 0u;
}

// h from a hash key (k, mask and state stand at 3 + MCX onwards).
__device__ __forceinline__ unsigned key_hash(const unsigned* key, int NK,
                                             int MW) {
  const unsigned* kms = key + NK - 1 - MW;
  return mix_hash(kms[0] ^ SIGN, reinterpret_cast<const int*>(kms + 1), MW,
                  kms[1 + MW] ^ SIGN);
}

// The order of two M-word keys. The first two words decide almost every
// comparison; the other M - 2 are read at once, not word after word, so
// that the lanes of a warp that tie on the first two cost it one more read.
template <int M>
__device__ __forceinline__ bool key_less(const unsigned* x,
                                         const unsigned* y) {
  const unsigned x0 = x[0], y0 = y[0], x1 = x[1], y1 = y[1];
  if (x0 != y0) return x0 < y0;
  if (x1 != y1) return x1 < y1;
  bool lt = false, eq = true;
#pragma unroll
  for (int w = 2; w < M; ++w) {
    const unsigned a = x[w], b = y[w];
    lt = lt || (eq && a < b);
    eq = eq && a == b;
  }
  return lt;
}

// n contiguous rows of NK words between device memory and a tile's keys,
// by the whole block: word by word up to the first 16-byte boundary, 16
// bytes a thread from there, word by word after the last. Word w is word
// c = w - r NK of row r = w / NK, the division by a multiply (exact for
// every w below 2^16 at NK up to 13; a tile's words fit the 227 KB of
// shared memory, so there are fewer than 58,112).
__device__ __forceinline__ int head_words(const int* g, int total) {
  return min(total, (int)((16 - ((size_t)g & 15)) & 15) >> 2);
}

template <int TB>
__device__ void load_tile(const int* g, int n, int NK, int MW, unsigned* sh,
                          int S) {
  const int total = n * NK, head = head_words(g, total);
  const int n4 = (total - head) >> 2, t = threadIdx.x, nt = blockDim.x;
  const unsigned inv = 0xffffffffu / NK + 1;
  auto put = [&](int w, int v) {
    const int r = (int)__umulhi((unsigned)w, inv), c = w - r * NK;
    sh[r * S + key_word<TB>(c, NK, MW)] = (unsigned)v ^ word_flip(c, MW);
  };
  for (int w = t; w < head; w += nt) put(w, g[w]);
  const int4* g4 = reinterpret_cast<const int4*>(g + head);
  for (int q = t; q < n4; q += nt) {
    const int4 v = g4[q];
    const int w = head + 4 * q;
    put(w, v.x);
    put(w + 1, v.y);
    put(w + 2, v.z);
    put(w + 3, v.w);
  }
  for (int w = head + 4 * n4 + t; w < total; w += nt) put(w, g[w]);
}

// The inverse: output row r from the key at key_of(r).
template <int TB, class F>
__device__ void store_tile(int* g, int n, int NK, int MW, F key_of) {
  const int total = n * NK, head = head_words(g, total);
  const int n4 = (total - head) >> 2, t = threadIdx.x, nt = blockDim.x;
  const unsigned inv = 0xffffffffu / NK + 1;
  auto get = [&](int w) {
    const int r = (int)__umulhi((unsigned)w, inv), c = w - r * NK;
    return (int)(key_of(r)[key_word<TB>(c, NK, MW)] ^ word_flip(c, MW));
  };
  for (int w = t; w < head; w += nt) g[w] = get(w);
  int4* g4 = reinterpret_cast<int4*>(g + head);
  for (int q = t; q < n4; q += nt) {
    const int w = head + 4 * q;
    g4[q] = make_int4(get(w), get(w + 1), get(w + 2), get(w + 3));
  }
  for (int w = head + 4 * n4 + t; w < total; w += nt) g[w] = get(w);
}

// Outputs [d, d + cnt) of the merge of sorted runs A and B (slot i of A is
// a(i), of B b(j); na and nb long; slot p's key at key_of(p)) into out[0,
// cnt): a binary search for where the merge path crosses diagonal d, then
// a serial merge. A's row goes first on a tie (tied rows are identical).
template <int M, class FA, class FB, class FK>
__device__ __forceinline__ void merge_slots(FA a, int na, FB b, int nb, int d,
                                            int cnt, uint16_t* out,
                                            FK key_of) {
  auto less = [&](int p, int q) { return key_less<M>(key_of(p), key_of(q)); };
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (less(b(d - 1 - mid), a(mid))) hi = mid;
    else lo = mid + 1;
  }
  int i = lo, j = d - lo;
  int sa = i < na ? a(i) : -1, sb = j < nb ? b(j) : -1;
  for (int k = 0; k < cnt; ++k) {
    if (sa < 0 || (sb >= 0 && less(sb, sa))) {
      out[k] = (uint16_t)sb;
      sb = ++j < nb ? b(j) : -1;
    } else {
      out[k] = (uint16_t)sa;
      sa = ++i < na ? a(i) : -1;
    }
  }
}

// The same crossing for runs A and B of rows in device memory, found by one
// warp: each step its 32 lanes test 32 points of the remaining range and a
// ballot keeps the span between the last point before the crossing and the
// first after it (4 steps for a run of 2^19 rows, not 20 dependent reads).
template <int TB>
__device__ int merge_path_rows(const int* A, int na, const int* B, int nb,
                               int d, int NK, int MW) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = lo + (int)(((long long)(hi - lo) * lane) >> 5);
    const int* x = B + (size_t)(d - 1 - mid) * NK;
    const int* y = A + (size_t)mid * NK;
    const bool before = !row_less<TB>(
        x, y, TB == TB_HASH ? row_hash(x, MW) : 0u,
        TB == TB_HASH ? row_hash(y, MW) : 0u, NK, MW);
    const int nt = __popc(__ballot_sync(FULL, before));
    const int mlast = __shfl_sync(FULL, mid, nt > 0 ? nt - 1 : 0);
    const int mnext = __shfl_sync(FULL, mid, nt < 32 ? nt : 31);
    lo = nt > 0 ? mlast + 1 : lo;
    hi = nt < 32 ? mnext : hi;
  }
  return lo;
}

// Outputs a tile-pass thread merges in each round, for `blocks` blocks of
// cap rows on a device of `sms` SMs (chip_smoke.py's states on the H100,
// PERF.md): one while a tile fits 1,024 threads and the launch fits the
// SMs at 512 threads each, where one block's latency sets the time; 2
// beyond that (a batch of keys) and 8 for a tile of more than 1,024 rows,
// where the work sets it and fewer threads spend fewer binary searches on
// the same merges. (A tile spread over a cluster of 4 blocks, merging
// through distributed shared memory, measured no faster than one block at
// V = 8.)
int tile_v(int cap, long long blocks, int sms) {
  if (cap > 1024) return 8;
  return blocks * cap > (long long)sms * 512 ? 2 : 1;
}

// A block's n rows, loaded as keys into sh (stride S = M | 1), sorted: each
// thread sorts V slots, then round L merges runs of L slots pairwise, each
// thread V outputs, between the slot arrays in and out. A round whose pairs
// lie within one warp's outputs (2L <= 32 V) waits for that warp only.
// Returns the array that holds the sorted slots.
template <int TB, int M>
__device__ uint16_t* sort_block(unsigned* sh, uint16_t* in, uint16_t* out,
                                int n, int V, int NK, int MW) {
  const int S = M | 1;
  auto key_of = [&](int p) { return sh + p * S; };
  // each thread's V rows: their h, then an insertion sort of their slots
  const int o = threadIdx.x * V, cnt = min(V, n - o);
  for (int k = 0; k < cnt; ++k) {
    const int s = o + k;
    if (TB == TB_HASH) sh[s * S + 1] = key_hash(key_of(s), NK, MW);
    int q = k;
    for (; q > 0 && key_less<M>(key_of(s), key_of(in[o + q - 1])); --q)
      in[o + q] = in[o + q - 1];
    in[o + q] = (uint16_t)s;
  }
  __syncwarp();
  for (int L = V; L < n; L <<= 1) {
    if (cnt > 0) {
      const int p0 = o & ~(2 * L - 1);
      const int a1 = min(p0 + L, n), b1 = min(p0 + 2 * L, n);
      const uint16_t* A = in + p0;
      const uint16_t* Bs = in + a1;
      merge_slots<M>([&](int i) { return (int)A[i]; }, a1 - p0,
                     [&](int j) { return (int)Bs[j]; }, b1 - a1, o - p0, cnt,
                     out + o, key_of);
    }
    if (4 * L <= 32 * V) __syncwarp();  // the next round's pairs: 4L rows
    else __syncthreads();
    uint16_t* t = in;
    in = out;
    out = t;
  }
  return in;
}

// Tile pass: grid (tiles, B), ceil(min(R, T) / V) threads rounded up to a
// warp; the tile of blockIdx.x sorted from src into dst (in place when they
// are one buffer: every row is read before the first barrier).
template <int TB, int M>
__global__ void __launch_bounds__(1024)
    sort_tile_kernel(const int* src, int* dst, const int* scal, int R, int RP,
                     int NK, int MW, int T, int cap, int V) {
  const int b = blockIdx.y;
  if (scal[(size_t)b * NSCAL + ACT] == 0) return;
  extern __shared__ int sh_words[];
  unsigned* sh = reinterpret_cast<unsigned*>(sh_words);
  const int S = M | 1;
  uint16_t* in = reinterpret_cast<uint16_t*>(sh + cap * S);
  const size_t base = ((size_t)b * RP + (size_t)blockIdx.x * T) * NK;
  const int n = min(T, R - (int)blockIdx.x * T);
  load_tile<TB>(src + base, n, NK, MW, sh, S);
  __syncthreads();
  const uint16_t* perm = sort_block<TB, M>(sh, in, in + cap, n, V, NK, MW);
  __syncthreads();
  store_tile<TB>(dst + base, n, NK, MW,
                 [&](int r) { return sh + perm[r] * S; });
}

// Merge pass: grid (ceil(R / MERGE_ROWS), B), MERGE_ROWS / MERGE_V threads;
// merges src's sorted runs of L rows pairwise into dst. Warps 0 and 1 find
// the block's two ends on its pair's merge path side by side; the two
// ranges they bound are merged in shared memory as a tile round merges.
template <int TB, int M>
__global__ void __launch_bounds__(MERGE_ROWS / MERGE_V)
    sort_merge_kernel(const int* src, int* dst, const int* scal, int R,
                      int RP, int NK, int MW, int L) {
  const int b = blockIdx.y;
  if (scal[(size_t)b * NSCAL + ACT] == 0) return;
  extern __shared__ int sh_words[];
  unsigned* sh = reinterpret_cast<unsigned*>(sh_words);
  __shared__ int split[2];
  const int S = M | 1;
  uint16_t* perm = reinterpret_cast<uint16_t*>(sh + MERGE_ROWS * S);
  const int* ksrc = src + (size_t)b * RP * NK;
  const int o0 = blockIdx.x * MERGE_ROWS, o1 = min(R, o0 + MERGE_ROWS);
  const int p0 = o0 & ~(2 * L - 1);
  const int a1 = min(p0 + L, R), b1 = min(p0 + 2 * L, R);
  const int* A = ksrc + (size_t)p0 * NK;
  const int* Bv = ksrc + (size_t)a1 * NK;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int i = merge_path_rows<TB>(A, a1 - p0, Bv, b1 - a1,
                                      (warp ? o1 : o0) - p0, NK, MW);
    if ((threadIdx.x & 31) == 0) split[warp] = i;
  }
  __syncthreads();
  const int i0 = split[0], j0 = o0 - p0 - i0;
  const int ma = split[1] - i0, n = o1 - o0, mb = n - ma;
  load_tile<TB>(A + (size_t)i0 * NK, ma, NK, MW, sh, S);
  load_tile<TB>(Bv + (size_t)j0 * NK, mb, NK, MW, sh + ma * S, S);
  __syncthreads();
  if (TB == TB_HASH) {
    for (int s = threadIdx.x; s < n; s += blockDim.x)
      sh[s * S + 1] = key_hash(sh + s * S, NK, MW);
    __syncthreads();
  }
  const int o = threadIdx.x * MERGE_V;
  if (o < n)
    merge_slots<M>([](int i) { return i; }, ma,
                   [ma](int j) { return ma + j; }, mb, o,
                   min(MERGE_V, n - o), perm + o,
                   [&](int p) { return sh + p * S; });
  __syncthreads();
  store_tile<TB>(dst + (size_t)b * RP * NK + (size_t)o0 * NK, n, NK, MW,
                 [&](int i) { return sh + perm[i] * S; });
}

// ---------------------------------------------------------------------------
// K3 group_scan (B6; tpu.py:605): g[i] = cummax(same_grp[i] ? 0 : i), the
// index of row i's group start, per key. Its one reader is K4's dominance
// test, which only a search with crashed ops (CR > 0) runs: the reference
// computes it under `if CR:` (tpu.py:602-605), and the port launches
// nothing for it at CR = 0.
//
// What bounds it. (3 + MW) words of each of the R live rows read and one
// written: bytes, a few microseconds' worth on the widest rungs, far less
// than a launch elsewhere. So where K4 holds the key's rows in shared
// memory (R <= T, dedup_block_kernel) the scan is done there, from those
// rows (block_group_starts): no launch, no read of the rows and no g in
// device memory. On the wide rungs (R > T) it is one launch,
// scan_local_kernel: a warp-shuffle max-scan of each SCAN_ROWS-row block
// of the R live rows, the block's scan into g and its maximum into gagg;
// dedup_kernel adds the blocks' carry where it reads g (a warp's max over
// gagg[0 .. q)), in place of a second pass over g. Grid (blocks, B).
// ---------------------------------------------------------------------------

constexpr int SCAN_ROWS = 1024;

// Rows i - 1 and i, at a stride of S words, are both valid and hold the
// same (key1, k, mask, state).
__device__ __forceinline__ bool same_grp(const int* rows, int S, int i,
                                         int MW) {
  if (i == 0) return false;
  const int* x = rows + (size_t)i * S;
  const int* y = x - S;
  if (x[0] > MAXK || y[0] > MAXK) return false;
  for (int w = 0; w < 3 + MW; ++w)
    if (x[w] != y[w]) return false;
  return true;
}

// The block's inclusive max-scan of v >= 0, by every thread of a block of
// whole warps: each warp's by shuffles, then warp 0's over the warp maxima
// in wmax (32 ints of shared memory). Returns the thread's prefix max and
// sets total to the block's. wmax is read until every thread has
// returned: a barrier must come before the next call.
__device__ __forceinline__ int block_max_scan(int v, int* wmax, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = max(v, y);
  }
  if (lane == 31) wmax[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? wmax[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w = max(w, y);
    }
    wmax[lane] = w;
  }
  __syncthreads();
  total = wmax[nw - 1];
  return warp > 0 ? max(v, wmax[warp - 1]) : v;
}

__global__ void __launch_bounds__(SCAN_ROWS)
    scan_local_kernel(const int* rows, const int* scal, int* g, int* gagg,
                      int R, int RP, int NK, int MW) {
  const int b = blockIdx.y;
  if (scal[(size_t)b * NSCAL + ACT] == 0) return;
  __shared__ int wmax[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int* krows = rows + (size_t)b * RP * NK;
  int total;
  const int v = block_max_scan(
      i < R && !same_grp(krows, NK, i, MW) ? i : 0, wmax, total);
  if (i < R) g[(size_t)b * RP + i] = v;
  if (threadIdx.x == 0) gagg[(size_t)b * gridDim.x + blockIdx.x] = total;
}

// ---------------------------------------------------------------------------
// K5 seg_active (B9: active at tpu.py:368-369, seg_active at :681-682, the
// condition of the reference's lax.while_loop(seg_active, body_n, carry)).
// After each level pair of a segment it adds the levels the pair ran to
// the segment's counter (the first always ran, the host launches only an
// active search; the second ran if some key's K1 found it active), then
// decides whether any key is still active (not done, rows alive, the level
// budget not spent) and the segment under its bound; in the segment graph
// it sets the WHILE node's condition.
//
// What bounds it. It reads B x 32 bytes of scalars: as a launch of its
// own it costs a graph node's floor, ~1.4 us. So in the segment graph it
// is the tail of the pair's second K4, whose blocks hold each key's new
// scalars in registers: with one key, the key's block decides from
// those; with B keys, each key's block puts its two flags (it ran the
// level; it is still active) on the ticket word seg[SEG_TICKET] and takes
// a ticket there, and the block that takes the last decides from the
// word's flags and zeroes it. Atomics on one word are ordered, so the last
// ticket sees every key's flags: no fence and no read of the B keys'
// scalars (reading them, one warp's loop of dependent L2 loads, cost
// ~2 us at 256 keys on the H100). The levels run and the bound are read as the K4 begins
// (only the decider writes them). seg_active_kernel, one block, is K5
// standing alone: the step of the host loop (jt_seg_active). Both run the
// rule below.
// ---------------------------------------------------------------------------

enum { SEG_RUN, SEG_BOUND, SEG_GO, SEG_TICKET, NSEG };
// the ticket word: tickets taken in its low bits, the keys' flags above
constexpr unsigned TICKET_RAN = 1u << 30, TICKET_ACT = 1u << 31;
constexpr unsigned TICKETS = TICKET_RAN - 1;

// A key's search goes on (tpu.py:368): not done, rows alive, the level
// budget not spent.
__device__ __forceinline__ bool key_active(int done, int nalive, int level,
                                           int lmax) {
  return done == 0 && nalive > 0 && level <= lmax;
}

// K5's three steps, by one thread: ran, some key ran the pair's second
// level; act, some key is still active; run and bound, seg's words.
__device__ __forceinline__ void seg_decide(bool ran, bool act, int run,
                                           int bound, int* seg,
                                           cudaGraphConditionalHandle cond,
                                           int in_graph) {
  run += 1 + ran;
  const int go = act && run < bound;
  seg[SEG_RUN] = run;
  seg[SEG_GO] = go;
  if (in_graph) cudaGraphSetConditional(cond, go);
}

// The pair's end for one of B keys, by one thread of the key's block,
// with the key's flags: onto the ticket word, then a ticket; the last of
// the B tickets decides from every key's flags (B = 1: at once).
__device__ void pair_end(bool ran, bool act, int B, int run, int bound,
                         int* seg, cudaGraphConditionalHandle cond,
                         int in_graph) {
  if (B > 1) {
    unsigned* word = reinterpret_cast<unsigned*>(seg + SEG_TICKET);
    const unsigned flags = (ran ? TICKET_RAN : 0u) | (act ? TICKET_ACT : 0u);
    if (flags) atomicOr(word, flags);
    const unsigned old = atomicAdd(word, 1u) | flags;
    if ((old & TICKETS) != (unsigned)B - 1) return;
    *word = 0u;
    ran = (old & TICKET_RAN) != 0u;
    act = (old & TICKET_ACT) != 0u;
  }
  seg_decide(ran, act, run, bound, seg, cond, in_graph);
}

__global__ void __launch_bounds__(256)
    seg_active_kernel(const int* scal, int B, int lmax, int* seg) {
  bool act = false, ran = false;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int* s = scal + (size_t)b * NSCAL;
    act |= key_active(s[DONE], s[NALIVE], s[LEVEL], lmax);
    ran |= s[ACT] != 0;
  }
  act = __syncthreads_or(act);
  ran = __syncthreads_or(ran);
  if (threadIdx.x == 0)
    seg_decide(ran, act, seg[SEG_RUN], seg[SEG_BOUND], seg,
               cudaGraphConditionalHandle(), 0);
}

// ---------------------------------------------------------------------------
// K4 dedup_truncate (B6-B7; tpu.py:589-664): the adjacent-duplicate test,
// the 8-leader subset-dominance test from the group start, the first-C
// truncation into the other pool buffer, pk/ps/pa, and the level's
// counters, stats row and scalars. While a key is inactive its pool is
// copied through unchanged: the per-lane masked update of tpu.py:652-654.
// In the segment graph the pair's second K4 also ends the pair (K5).
//
// What bounds it. Not bytes (R rows read once, C pool rows written) and
// not operations: latency. A row's tests read its neighbour and up to 8
// leader rows found through its group start; and a key's counters are
// summed across its blocks, so with a block per 256 rows a level ends in
// a serial tail through L2 (atomics on the key's accumulators, a fence, a
// ticket, a barrier, then a fence and volatile reads in the key's last
// block).
//
// Design: two paths, both one CUDA launch; the host picks one per shape
// (kernels/search.py dedup_one_block).
//   R <= T (tile_rows: 4,096 rows at every NK up to 12; the single, keyed
//   and gang states and every model's first rung but the set's):
//   dedup_block_kernel, one block of up to 1,024 threads per key. It
//   loads the key's R rows into shared memory with 16-byte loads, at an
//   odd word stride so that a warp's neighbouring rows fall in different
//   banks; where CR > 0 it scans their group starts there (K3, 16-bit,
//   after the rows); dup, dominance and truncation then read shared memory
//   only. The key's flag, thread 0's scalars and K1's expanded count and
//   each thread's first pool entries are read in the same hop as the rows.
//   The counters are block reductions (warp reductions into shared memory,
//   then one warp over those); thread 0 writes the stats row and the
//   scalars and zeroes the accumulators: no atomic, ticket or fence. Its
//   shared memory above 48 KB is granted before a graph capture begins
//   (GRANT_ONLY).
//   R > T (the wide rungs): dedup_kernel, a thread per row in blocks of
//   256, the group starts from K3 with its carry, warp reductions into the
//   key's accumulators, and the key's last block (a ticket per key)
//   writing its stats row and scalars and zeroing its accumulators.
// ---------------------------------------------------------------------------

struct DedupArgs {
  const int* rows;
  const int* g;
  const int* gagg;
  PoolIn pin;
  PoolOut pout;
  int* pk;
  int* ps;
  uint8_t* pa;
  const int* nr;
  int* scal;
  int* acc;
  // the per-level counter rows; null when the stats lane is off (tracing
  // off), and then no row is written
  int* stats;
  // the pair's second level only: the segment's words, which the launch
  // ends the pair in (K5), and, in the segment graph, the WHILE node's
  // condition; null otherwise
  int* seg;
  cudaGraphConditionalHandle cond;
  int in_graph;
  int C, MW, MCX, NK, CR, R, RP, lmax;
};

// The pair's end at key blockIdx.y's block, by one thread: ran, the key
// ran this level; act, it is still active; sw, seg's levels run and bound
// as the launch began.
__device__ __forceinline__ void key_pair_end(const DedupArgs& a, bool ran,
                                             bool act, const int* sw) {
  pair_end(ran, act, gridDim.y, sw[0], sw[1], a.seg, a.cond, a.in_graph);
}

// Both paths' row work. Rows lie at a stride of S words: device memory at
// NK, a block's shared tile at NK | 1.

// An inactive key's pool entry i, copied through.
__device__ __forceinline__ void copy_pool(const PoolIn& pin,
                                          const PoolOut& pout, int i, int MW,
                                          int MCX) {
  pout.k[i] = pin.k[i];
  for (int w = 0; w < MW; ++w) pout.mask[i * MW + w] = pin.mask[i * MW + w];
  for (int w = 0; w < MCX; ++w)
    pout.cmask[i * MCX + w] = pin.cmask[i * MCX + w];
  pout.state[i] = pin.state[i];
  pout.alive[i] = pin.alive[i];
}

// Row i's tests: fv, the row is valid; dup, the row before has the same
// (key1, k, mask, state, cmask); dom, one of its group's first LEADERS
// rows (from gi, used only where crashed) has its (key1, k, mask, state)
// and a cmask that row i's covers.
__device__ __forceinline__ void row_tests(const int* rows, int S, int i,
                                          int gi, int R, int MW, int NK,
                                          bool crashed, bool& fv, bool& dup,
                                          bool& dom) {
  const int* ri = rows + (size_t)i * S;
  fv = ri[0] <= MAXK;
  dup = false;
  dom = false;
  if (i > 0) {
    const int* rp = ri - S;
    dup = fv && rp[0] <= MAXK;
    for (int w = 0; w < 3 + MW && dup; ++w) dup = ri[w] == rp[w];
    for (int w = 4 + MW; w < NK && dup; ++w) dup = ri[w] == rp[w];
  }
  if (crashed && fv) {
    for (int p = 0; p < LEADERS && !dom; ++p) {
      const int li = min(gi + p, R - 1);
      if (li >= i) break;
      const int* rl = rows + (size_t)li * S;
      bool lead = true;
      for (int w = 0; w < 3 + MW && lead; ++w) lead = rl[w] == ri[w];
      bool subset = true;
      for (int w = 4 + MW; w < NK && subset; ++w) {
        const unsigned cl = rl[w], ci = ri[w];
        subset = (ci & cl) == cl;
      }
      dom = lead && subset;
    }
  }
}

// Pool entry i < C from row ri, alive where the row is unique.
__device__ __forceinline__ void pool_write(const PoolOut& pout, int i,
                                           const int* ri, int MW, int MCX,
                                           bool uniq) {
  pout.k[i] = ri[1];
  for (int w = 0; w < MW; ++w) pout.mask[i * MW + w] = (unsigned)ri[2 + w];
  for (int w = 0; w < MCX; ++w)
    pout.cmask[i * MCX + w] = (unsigned)ri[4 + MW + w];
  pout.state[i] = ri[2 + MW];
  pout.alive[i] = uniq;
}

__global__ void __launch_bounds__(256) dedup_kernel(DedupArgs a) {
  const int t = threadIdx.x, b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + t;
  const int MW = a.MW, MCX = a.MCX, NK = a.NK, C = a.C;
  const PoolIn pin = pool_at(a.pin, b, C, MW, MCX);
  const PoolOut pout = pool_at(a.pout, b, C, MW, MCX);
  int* scal = a.scal + (size_t)b * NSCAL;
  if (scal[ACT] == 0) {
    if (i < C) copy_pool(pin, pout, i, MW, MCX);
    // the key's first block ends the pair for it: it ran no level
    if (a.seg != nullptr && blockIdx.x == 0 && t == 0) {
      const int sw[2] = {a.seg[SEG_RUN], a.seg[SEG_BOUND]};
      key_pair_end(a, false,
                   key_active(scal[DONE], scal[NALIVE], scal[LEVEL],
                              a.lmax),
                   sw);
    }
    return;
  }
  // seg's words, for the key's last block if it ends the pair
  int sw[2] = {0, 0};
  if (a.seg != nullptr && t == 0) {
    sw[0] = a.seg[SEG_RUN];
    sw[1] = a.seg[SEG_BOUND];
  }
  const int* rows = a.rows + (size_t)b * a.RP * NK;
  const int* g = a.g + (size_t)b * a.RP;
  int* acc = a.acc + (size_t)b * NACC;
  const int nr = a.nr[b];

  // the carry of K3's blocks before this block's rows: a warp's max over
  // gagg[0 .. q), q the scan block of this block's rows
  int carry = 0;
  if (a.CR > 0) {
    const int q = blockIdx.x * blockDim.x / SCAN_ROWS;
    const int* gagg =
        a.gagg + (size_t)b * ((a.R + SCAN_ROWS - 1) / SCAN_ROWS);
    for (int j = t & 31; j < q; j += 32) carry = max(carry, gagg[j]);
    carry = __reduce_max_sync(FULL, carry);
  }
  bool fv = false, dup = false, dom = false, uniq = false;
  int fk = 0;
  if (i < a.R) {
    const int gi = a.CR > 0 ? max(g[i], carry) : 0;
    row_tests(rows, NK, i, gi, a.R, MW, NK, a.CR > 0, fv, dup, dom);
    fk = rows[(size_t)i * NK + 1];
    uniq = fv && !dup && !dom;
  }
  if (i < C) {
    pool_write(pout, i, rows + (size_t)i * NK, MW, MCX, uniq);
    a.pk[(size_t)b * C + i] = pin.k[i];
    a.ps[(size_t)b * C + i] = pin.state[i];
    a.pa[(size_t)b * C + i] = pin.alive[i];
  }

  const bool kept = i < C && uniq, lost = i >= C && uniq;
  const unsigned done_any = __reduce_or_sync(FULL, fv && fk >= nr);
  const int best = __reduce_max_sync(FULL, fv ? fk : 0);
  const unsigned ndup = __reduce_add_sync(FULL, dup);
  const unsigned ndom = __reduce_add_sync(FULL, dom);
  const unsigned nlost = __reduce_add_sync(FULL, lost);
  const unsigned nkept = __reduce_add_sync(FULL, kept);
  if ((t & 31) == 0) {
    if (done_any) atomicOr(&acc[A_DONE], 1);
    if (nlost) atomicOr(&acc[A_LOSSY], 1);
    atomicMax(&acc[A_BEST], best);
    if (ndup) atomicAdd(&acc[A_DUP], (int)ndup);
    if (ndom) atomicAdd(&acc[A_DOM], (int)ndom);
    if (nlost) atomicAdd(&acc[A_TRUNC], (int)nlost);
    if (nkept) atomicAdd(&acc[A_FRONTIER], (int)nkept);
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (t == 0) last = atomicAdd(&acc[A_TICKET], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last || t > 0) return;
  {
    __threadfence();
    volatile int* vacc = acc;
    const int level = scal[LEVEL];
    if (a.stats != nullptr) {  // the stats lane is off without a buffer
      int* srow = a.stats
                  + ((size_t)b * (a.lmax + 1) + clampi(level, 0, a.lmax))
                        * NSTAT;
      srow[0] = vacc[A_EXPANDED];
      srow[1] = vacc[A_DUP];
      srow[2] = vacc[A_DOM];
      srow[3] = vacc[A_TRUNC];
      srow[4] = vacc[A_FRONTIER];
    }
    const int done = scal[DONE] | vacc[A_DONE];
    const int nalive = vacc[A_FRONTIER];
    scal[DONE] = done;
    scal[LOSSY] |= vacc[A_LOSSY];
    scal[LEVEL] = level + 1;
    scal[BEST] = max(scal[BEST], (int)vacc[A_BEST]);
    scal[NALIVE] = nalive;
    for (int q = 0; q < NACC; ++q) vacc[q] = 0;
    if (a.seg != nullptr)
      key_pair_end(a, true, key_active(done, nalive, level + 1, a.lmax), sw);
  }
}

// n rows of NK words from device memory (16-byte aligned) into shared
// memory at stride S, by the whole block: 16 bytes a thread, then the
// last words one by one. Word w is word c = w - r NK of row r = w / NK,
// the division by a multiply as in load_tile.
__device__ void load_rows(const int* g, int n, int NK, int* sh, int S) {
  const int total = n * NK, n4 = total >> 2;
  const int t = threadIdx.x, nt = blockDim.x;
  const unsigned inv = 0xffffffffu / NK + 1;
  auto put = [&](int w, int v) {
    const int r = (int)__umulhi((unsigned)w, inv);
    sh[r * S + (w - r * NK)] = v;
  };
  const int4* g4 = reinterpret_cast<const int4*>(g);
  for (int q = t; q < n4; q += nt) {
    const int4 v = g4[q];
    put(4 * q, v.x);
    put(4 * q + 1, v.y);
    put(4 * q + 2, v.z);
    put(4 * q + 3, v.w);
  }
  for (int w = 4 * n4 + t; w < total; w += nt) put(w, g[w]);
}

// K3 in dedup_block_kernel: each of the R rows' group starts into gs
// (16-bit: R <= 4,096), by the whole block from the rows in shared memory
// at stride S. The rows go in stripes of blockDim.x (thread t's are t,
// t + nt, ..., as in the row loop), each stripe a block max-scan carried
// on from the stripes before: at most 4 at R = 4,096.
__device__ void block_group_starts(const int* rows, int S, int R, int MW,
                                   uint16_t* gs, int* wmax) {
  int carry = 0;
  for (int i0 = 0; i0 < R; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    int total;
    const int v = block_max_scan(
        i < R && !same_grp(rows, S, i, MW) ? i : 0, wmax, total);
    if (i < R) gs[i] = (uint16_t)max(v, carry);
    carry = max(carry, total);
    // wmax is read again by the next stripe's scan; a thread reads back
    // only the starts it wrote
    if (i0 + (int)blockDim.x < R) __syncthreads();
  }
}

// At most 32 registers a thread, so that two blocks of up to 1,024
// threads share an SM: a 184-key batch at R = 768 in one wave.
__global__ void __launch_bounds__(1024, 2) dedup_block_kernel(DedupArgs a) {
  const int t = threadIdx.x, nt = blockDim.x, b = blockIdx.y;
  const int lane = t & 31, warp = t >> 5;
  const int MW = a.MW, MCX = a.MCX, NK = a.NK, C = a.C, R = a.R;
  const PoolIn pin = pool_at(a.pin, b, C, MW, MCX);
  const PoolOut pout = pool_at(a.pout, b, C, MW, MCX);
  int* scal = a.scal + (size_t)b * NSCAL;
  int* acc = a.acc + (size_t)b * NACC;
  extern __shared__ int sh_words[];
  __shared__ int part[32][6];  // per warp: done, best, dup, dom, lost, kept
  __shared__ int wmax[32];
  const int S = NK | 1;
  // the rows at stride S, then (CR > 0) their group starts
  uint16_t* gs = reinterpret_cast<uint16_t*>(sh_words + R * S);
  // one hop: the key's flag, thread 0's scalars and K1's expanded count,
  // the thread's first row's pool entries, and the rows into shared
  // memory. seg's words wait for the end: held through the row loop they
  // cost spills there (0.0004 ms at 184 keys on the H100).
  const int act = scal[ACT], nr = a.nr[b];
  int sc[5] = {0, 0, 0, 0, 0};  // thread 0: done, lossy, level, best, live
  int expanded = 0;
  if (t == 0) {
    sc[0] = scal[DONE];
    sc[1] = scal[LOSSY];
    sc[2] = scal[LEVEL];
    sc[3] = scal[BEST];
    sc[4] = scal[NALIVE];
    expanded = acc[A_EXPANDED];
  }
  const int k0 = t < C ? pin.k[t] : 0, s0 = t < C ? pin.state[t] : 0;
  const uint8_t a0 = t < C ? pin.alive[t] : 0;
  load_rows(a.rows + (size_t)b * a.RP * NK, R, NK, sh_words, S);
  if (act == 0) {
    for (int i = t; i < C; i += nt) copy_pool(pin, pout, i, MW, MCX);
    if (a.seg != nullptr && t == 0) {
      const int sw[2] = {a.seg[SEG_RUN], a.seg[SEG_BOUND]};
      key_pair_end(a, false, key_active(sc[0], sc[4], sc[2], a.lmax), sw);
    }
    return;
  }
  __syncthreads();
  if (a.CR > 0) block_group_starts(sh_words, S, R, MW, gs, wmax);

  int ndup = 0, ndom = 0, nlost = 0, nkept = 0, best = 0;
  bool done = false;
  for (int i = t; i < R; i += nt) {
    const bool first = i == t;
    const int* ri = sh_words + i * S;
    const int gi = a.CR > 0 ? gs[i] : 0;
    bool fv, dup, dom;
    row_tests(sh_words, S, i, gi, R, MW, NK, a.CR > 0, fv, dup, dom);
    const bool uniq = fv && !dup && !dom;
    if (i < C) {
      pool_write(pout, i, ri, MW, MCX, uniq);
      a.pk[(size_t)b * C + i] = first ? k0 : pin.k[i];
      a.ps[(size_t)b * C + i] = first ? s0 : pin.state[i];
      a.pa[(size_t)b * C + i] = first ? a0 : pin.alive[i];
    }
    ndup += dup;
    ndom += dom;
    nlost += i >= C && uniq;
    nkept += i < C && uniq;
    done = done || (fv && ri[1] >= nr);
    best = max(best, fv ? ri[1] : 0);
  }

  // the key's sums: each warp's into part, then warp 0's over those
  const unsigned d = __reduce_or_sync(FULL, done);
  const int mx = __reduce_max_sync(FULL, best);
  const int sdup = __reduce_add_sync(FULL, ndup);
  const int sdom = __reduce_add_sync(FULL, ndom);
  const int slost = __reduce_add_sync(FULL, nlost);
  const int skept = __reduce_add_sync(FULL, nkept);
  if (lane == 0) {
    part[warp][0] = d;
    part[warp][1] = mx;
    part[warp][2] = sdup;
    part[warp][3] = sdom;
    part[warp][4] = slost;
    part[warp][5] = skept;
  }
  __syncthreads();
  if (warp > 0) return;
  // seg's words, loaded under the warp's sums below
  int sw[2] = {0, 0};
  if (lane == 0 && a.seg != nullptr) {
    sw[0] = a.seg[SEG_RUN];
    sw[1] = a.seg[SEG_BOUND];
  }
  const bool in = lane < (nt >> 5);
  const unsigned kd = __reduce_or_sync(FULL, in ? part[lane][0] : 0);
  const int kbest = __reduce_max_sync(FULL, in ? part[lane][1] : 0);
  const int kdup = __reduce_add_sync(FULL, in ? part[lane][2] : 0);
  const int kdom = __reduce_add_sync(FULL, in ? part[lane][3] : 0);
  const int klost = __reduce_add_sync(FULL, in ? part[lane][4] : 0);
  const int kkept = __reduce_add_sync(FULL, in ? part[lane][5] : 0);
  if (lane == 0) {
    const int level = sc[2];
    if (a.stats != nullptr) {  // the stats lane is off without a buffer
      int* srow = a.stats
                  + ((size_t)b * (a.lmax + 1) + clampi(level, 0, a.lmax))
                        * NSTAT;
      srow[0] = expanded;
      srow[1] = kdup;
      srow[2] = kdom;
      srow[3] = klost;
      srow[4] = kkept;
    }
    const int kdone = sc[0] | (kd != 0u);
    scal[DONE] = kdone;
    scal[LOSSY] = sc[1] | (klost != 0);
    scal[LEVEL] = level + 1;
    scal[BEST] = max(sc[3], kbest);
    scal[NALIVE] = kkept;
    for (int q = 0; q < NACC; ++q) acc[q] = 0;
    if (a.seg != nullptr)
      key_pair_end(a, true, key_active(kdone, kkept, level + 1, a.lmax),
                   sw);
  }
}

int padded_rows(int R) {
  int RP = 2;
  while (RP < R) RP <<= 1;
  return RP;
}

int mask_words(int W) { return (W + 31) / 32; }
int cmask_words(int CR) { return CR > 32 ? (CR + 31) / 32 : 1; }

// An attribute of the current device.
int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

template <class Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (bytes > (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin))
    return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// What a call of sort_rows_m or dedup_any does: grant the kernels' shared
// memory and launch them; only grant it (before a graph capture begins);
// or only launch (inside the capture, where the grant was made before).
enum { LAUNCH_ALL, GRANT_ONLY, LAUNCH_ONLY };

// K2's launches for keys of M words: the tile pass over tiles of T rows,
// then `passes` merge passes ping-ponging between rows and alt, the last
// one into rows (T and passes from kernels/search.py tile_rows and
// sort_passes). Refuses a T beyond the 16-bit slots, runs that do not
// cover R (or whose width overflows an int), and a tile whose shared
// memory the device does not grant; alt may be null when passes is 0.
// Adds each launch to *launched.
template <int TB, int M>
int sort_rows_m(int* rows, int* alt, const int* scal, int B, int R, int RP,
                int NK, int MW, int T, int passes, int mode, cudaStream_t st,
                int* launched) {
  const int S = M | 1;
  const long long span =
      passes >= 0 && passes <= 30 ? (long long)T << passes : 0;
  if (T < 1 || T > 65536 || span < R || span > 0x7fffffffLL ||
      (passes > 0 && alt == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles = (R + T - 1) / T, cap = R < T ? R : T;
  const int V = tile_v(cap, (long long)B * tiles,
                       device_attr(cudaDevAttrMultiProcessorCount));
  const size_t tile_smem = (size_t)cap * (4 * S + 2 * sizeof(uint16_t));
  const size_t merge_smem = (size_t)MERGE_ROWS * (4 * S + sizeof(uint16_t));
  if (mode != LAUNCH_ONLY) {
    cudaError_t e = allow_smem(sort_tile_kernel<TB, M>, tile_smem);
    if (e == cudaSuccess && passes > 0)
      e = allow_smem(sort_merge_kernel<TB, M>, merge_smem);
    if (e != cudaSuccess || mode == GRANT_ONLY) return (int)e;
  }
  const int threads = ((cap + V - 1) / V + 31) / 32 * 32;
  int* cur = passes % 2 ? alt : rows;
  sort_tile_kernel<TB, M><<<dim3(tiles, B), threads, tile_smem, st>>>(
      rows, cur, scal, R, RP, NK, MW, T, cap, V);
  ++*launched;
  if (passes > 0) {
    const dim3 grid((R + MERGE_ROWS - 1) / MERGE_ROWS, B);
    for (int p = 0, L = T; p < passes; ++p, L <<= 1) {
      int* next = cur == rows ? alt : rows;
      sort_merge_kernel<TB, M>
          <<<grid, MERGE_ROWS / MERGE_V, merge_smem, st>>>(
              cur, next, scal, R, RP, NK, MW, L);
      ++*launched;
      cur = next;
    }
  }
  return (int)cudaGetLastError();
}

// One instantiation per key length: the comparator's loop is unrolled to
// exactly the key's words.
template <int TB>
int sort_rows(int* rows, int* alt, const int* scal, int B, int R, int RP,
              int NK, int MW, int T, int passes, int mode, cudaStream_t st,
              int* launched) {
  switch (NK + (TB == TB_HASH ? 1 : 0)) {
#define JT_SORT_M(M)                                                      \
  case M:                                                                 \
    return sort_rows_m<TB, M>(rows, alt, scal, B, R, RP, NK, MW, T, passes, \
                              mode, st, launched);
    JT_SORT_M(6) JT_SORT_M(7) JT_SORT_M(8) JT_SORT_M(9) JT_SORT_M(10)
    JT_SORT_M(11) JT_SORT_M(12) JT_SORT_M(13)
#undef JT_SORT_M
    default: return (int)cudaErrorInvalidValue;
  }
}

int sort_any(int* rows, int* alt, const int* scal, int B, int R, int RP,
             int NK, int MW, int tiebreak, int T, int passes, int mode,
             cudaStream_t st, int* launched) {
  return tiebreak == TB_HASH
             ? sort_rows<TB_HASH>(rows, alt, scal, B, R, RP, NK, MW, T,
                                  passes, mode, st, launched)
             : sort_rows<TB_LEX>(rows, alt, scal, B, R, RP, NK, MW, T, passes,
                                 mode, st, launched);
}

// dedup_block_kernel's dynamic shared memory: the key's R rows at stride
// NK | 1 and, where CR > 0, their 16-bit group starts (kernels/search.py
// dedup_block_smem).
size_t dedup_block_smem(int R, int NK, int CR) {
  return (size_t)R * (NK | 1) * sizeof(int)
         + (CR > 0 ? (size_t)R * sizeof(uint16_t) : 0);
}

// K4's launch for B keys: dedup_block_kernel, a block per key, when
// one_block (kernels/search.py dedup_one_block: R <= T and the block's
// shared memory fits); else dedup_kernel, a block per 256 rows of each
// key. Adds the launch to *launched.
int dedup_any(const DedupArgs& a, int B, int one_block, int mode,
              cudaStream_t st, int* launched) {
  if (!one_block) {
    if (mode == GRANT_ONLY) return 0;
    dedup_kernel<<<dim3((a.R + 255) / 256, B), 256, 0, st>>>(a);
    ++*launched;
    return (int)cudaGetLastError();
  }
  const size_t smem = dedup_block_smem(a.R, a.NK, a.CR);
  if (mode != LAUNCH_ONLY) {
    const cudaError_t e = allow_smem(dedup_block_kernel, smem);
    if (e != cudaSuccess || mode == GRANT_ONLY) return (int)e;
  }
  const int threads = a.R < 1024 ? (a.R + 31) / 32 * 32 : 1024;
  dedup_block_kernel<<<dim3(1, B), threads, smem, st>>>(a);
  ++*launched;
  return (int)cudaGetLastError();
}

// K4's arguments; seg non-null makes the launch end the level pair (K5),
// outside a graph until the caller sets cond and in_graph.
DedupArgs dedup_args(const int* rows, const int* g, const int* gagg,
                     const PoolIn& pin, const PoolOut& pout, int* pk,
                     int* ps, uint8_t* pa, const int* nr, int* scal,
                     int* acc, int* stats, int* seg, int C, int W, int CR,
                     int R, int lmax) {
  DedupArgs a;
  a.rows = rows;
  a.g = g;
  a.gagg = gagg;
  a.pin = pin;
  a.pout = pout;
  a.pk = pk;
  a.ps = ps;
  a.pa = pa;
  a.nr = nr;
  a.scal = scal;
  a.acc = acc;
  a.stats = stats;
  a.seg = seg;
  a.cond = cudaGraphConditionalHandle();
  a.in_graph = 0;
  a.C = C;
  a.MW = mask_words(W);
  a.MCX = cmask_words(CR);
  a.NK = 4 + a.MW + a.MCX;
  a.CR = CR;
  a.R = R;
  a.RP = padded_rows(R);
  a.lmax = lmax;
  return a;
}

// B9: one segment of levels as a CUDA graph. A memset node zeroes the
// segment's level counter, then a WHILE conditional node (its condition 1
// at each launch) runs its body until K5 clears the condition: the body
// is a level pair, pool A into pool B, then B back into A, whose second K4
// ends with K5's step, so the pool pointers are where they started after
// every iteration and the host's buffers need no swap. The body is
// captured from the same launch functions as the single-level entry
// points; K2's and K4's shared-memory grants are made before the capture
// begins.
struct SegmentGraph {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
};

// The level pair, K5 in its second K4, captured into `body` on stream st;
// scan: whether K3 runs as a launch of its own (kernels/search.py
// group_scan_runs).
struct PairArgs {
  const int *f, *v1, *v2, *ro, *fr, *inv, *ret, *sm, *cf, *cv1, *cv2, *cinv,
      *cps, *cb, *nr;
  PoolOut a, b;
  int *pk, *ps, *scal, *acc, *rows, *alt, *g, *gagg, *stats, *seg;
  uint8_t* pa;
  int B, C, W, E, n, CR, lmax, model, tiebreak, T, passes, dedup_block,
      scan;
};

}  // namespace

extern "C" int jt_expand(const int*, const int*, const int*, const int*,
                         const int*, const int*, const int*, const int*,
                         const int*, const int*, const int*, const int*,
                         const int*, const int*, const int*, const int*,
                         const unsigned*, const unsigned*, const int*,
                         const uint8_t*, int*, int*, int*, int, int, int, int,
                         int, int, int, int, void*, int*);
extern "C" int jt_group_scan(const int*, const int*, int*, int*, int, int,
                             int, int, int, void*, int*);

namespace {

// Captures one level pair on st, K3 only where p.scan, the second K4
// ending the pair (K5's step); counts[0..3] take the CUDA launches of K1,
// K2, K3 and K4.
int capture_pair(const PairArgs& p, cudaGraphConditionalHandle cond,
                 cudaStream_t st, int* counts) {
  const int MW = mask_words(p.W), MCX = cmask_words(p.CR);
  const int NK = 4 + MW + MCX;
  const int R = p.E * (p.W + 1 + p.CR) + (p.C - p.E);
  const int RP = padded_rows(R);
  for (int level = 0; level < 2; ++level) {
    const PoolOut& in = level ? p.b : p.a;
    const PoolOut& out = level ? p.a : p.b;
    int e = jt_expand(p.f, p.v1, p.v2, p.ro, p.fr, p.inv, p.ret, p.sm, p.cf,
                      p.cv1, p.cv2, p.cinv, p.cps, p.cb, p.nr, in.k, in.mask,
                      in.cmask, in.state, in.alive, p.scal, p.acc, p.rows,
                      p.B, p.C, p.W, p.E, p.n, p.CR, p.lmax, p.model, st,
                      &counts[0]);
    if (!e)
      e = sort_any(p.rows, p.alt, p.scal, p.B, R, RP, NK, MW, p.tiebreak,
                   p.T, p.passes, LAUNCH_ONLY, st, &counts[1]);
    if (!e && p.scan)
      e = jt_group_scan(p.rows, p.scal, p.g, p.gagg, p.B, R, RP, NK, MW, st,
                        &counts[2]);
    if (!e) {
      DedupArgs a = dedup_args(
          p.rows, p.g, p.gagg,
          PoolIn{in.k, in.mask, in.cmask, in.state, in.alive}, out, p.pk,
          p.ps, p.pa, p.nr, p.scal, p.acc, p.stats, level ? p.seg : nullptr,
          p.C, p.W, p.CR, R, p.lmax);
      a.cond = cond;
      a.in_graph = 1;
      e = dedup_any(a, p.B, p.dedup_block, LAUNCH_ONLY, st, &counts[3]);
    }
    if (e) return e;
  }
  return 0;
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int jt_expand(const int* f, const int* v1, const int* v2, const int* ro,
              const int* fr, const int* inv, const int* ret, const int* sm,
              const int* cf, const int* cv1, const int* cv2, const int* cinv,
              const int* cps, const int* cb, const int* nr, const int* k,
              const unsigned* mask, const unsigned* cmask, const int* state,
              const uint8_t* alive, int* scal, int* acc, int* rows, int B,
              int C, int W, int E, int n, int CR, int lmax, int model,
              void* stream, int* launched) {
  if (model < 0 || model >= NMODELS || W < 1 || W > 32 * MAXW ||
      CR > 32 * MAXW)
    return (int)cudaErrorInvalidValue;
  ExpandArgs a;
  a.c = Cols{f, v1, v2, ro, fr, inv, ret, sm, cf, cv1, cv2, cinv, cps, cb};
  a.pool = PoolIn{k, mask, cmask, state, alive};
  a.nr = nr;
  a.scal = scal;
  a.acc = acc;
  a.rows = rows;
  a.C = C;
  a.W = W;
  a.E = E;
  a.n = n;
  a.CR = CR;
  a.MW = mask_words(W);
  a.MCX = cmask_words(CR);
  a.NK = 4 + a.MW + a.MCX;
  a.R = E * (W + 1 + CR) + (C - E);
  a.RP = padded_rows(a.R);
  a.lmax = lmax;
  // the expanding blocks, then the tail blocks over rows [R0, RP)
  const int tail = a.RP - E * (W + 1 + CR);
  const dim3 grid((E + EXPAND_WARPS - 1) / EXPAND_WARPS
                      + (tail + TAIL_ROWS - 1) / TAIL_ROWS,
                  B);
  const int threads = 32 * EXPAND_WARPS;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (model) {
    case M_MUTEX: expand_kernel<M_MUTEX><<<grid, threads, 0, st>>>(a); break;
    case M_NOOP: expand_kernel<M_NOOP><<<grid, threads, 0, st>>>(a); break;
    case M_SET: expand_kernel<M_SET><<<grid, threads, 0, st>>>(a); break;
    case M_UQUEUE:
      expand_kernel<M_UQUEUE><<<grid, threads, 0, st>>>(a);
      break;
    case M_FIFO: expand_kernel<M_FIFO><<<grid, threads, 0, st>>>(a); break;
    default: expand_kernel<M_CAS><<<grid, threads, 0, st>>>(a); break;
  }
  ++*launched;
  return (int)cudaGetLastError();
}

int jt_sort_rows(int* rows, int* alt, const int* scal, int B, int R, int RP,
                 int NK, int MW, int tiebreak, int T, int passes, void* stream,
                 int* launched) {
  return sort_any(rows, alt, scal, B, R, RP, NK, MW, tiebreak, T, passes,
                  LAUNCH_ALL, (cudaStream_t)stream, launched);
}

// K3 over the R live rows of B keys' [RP, NK] rows: each block's scan into
// g, its maximum into gagg ([B, ceil(R / SCAN_ROWS)]).
int jt_group_scan(const int* rows, const int* scal, int* g, int* gagg, int B,
                  int R, int RP, int NK, int MW, void* stream,
                  int* launched) {
  if (R < 1 || R > RP) return (int)cudaErrorInvalidValue;
  const int threads = R < SCAN_ROWS ? (R + 31) / 32 * 32 : SCAN_ROWS;
  scan_local_kernel<<<dim3((R + threads - 1) / threads, B), threads, 0,
                      (cudaStream_t)stream>>>(rows, scal, g, gagg, R, RP, NK,
                                              MW);
  ++*launched;
  return (int)cudaGetLastError();
}

// K4; with seg non-null the launch also ends the level pair (K5's step,
// no conditional: outside a graph).
int jt_dedup_truncate(const int* rows, const int* g, const int* gagg,
                      const int* in_k, const unsigned* in_mask,
                      const unsigned* in_cmask, const int* in_state,
                      const uint8_t* in_alive, int* out_k,
                      unsigned* out_mask, unsigned* out_cmask,
                      int* out_state, uint8_t* out_alive, int* pk, int* ps,
                      uint8_t* pa, const int* nr, int* scal, int* acc,
                      int* stats, int B, int C, int W, int CR, int R,
                      int lmax, int one_block, int* seg, void* stream,
                      int* launched) {
  return dedup_any(
      dedup_args(rows, g, gagg,
                 PoolIn{in_k, in_mask, in_cmask, in_state, in_alive},
                 PoolOut{out_k, out_mask, out_cmask, out_state, out_alive},
                 pk, ps, pa, nr, scal, acc, stats, seg, C, W, CR, R, lmax),
      B, one_block, LAUNCH_ALL, (cudaStream_t)stream, launched);
}

int jt_seg_active(const int* scal, int* seg, int B, int lmax, void* stream,
                  int* launched) {
  seg_active_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(scal, B, lmax, seg);
  ++*launched;
  return (int)cudaGetLastError();
}

// The CUDA versions of this build and of the driver, as 1000 * major +
// 10 * minor.
int jt_cuda_versions(int* runtime, int* driver) {
  *runtime = CUDART_VERSION;
  return (int)cudaDriverGetVersion(driver);
}

// Builds the segment graph over the buffers of one search shape: the
// pointers and ints of jt_expand, jt_sort_rows, jt_group_scan and
// jt_dedup_truncate for it, with the pool the host holds (a) and the
// other pool buffer (b), and seg, the segment's int32 words (levels run,
// bound, go, ticket), whether K3 runs as a launch of its own (scan).
// Writes the graph's handle to *out and the CUDA launches one iteration
// of its body makes, per kernel K1..K4, to counts[0..3].
int jt_segment_graph_create(
    const int* f, const int* v1, const int* v2, const int* ro, const int* fr,
    const int* inv, const int* ret, const int* sm, const int* cf,
    const int* cv1, const int* cv2, const int* cinv, const int* cps,
    const int* cb, const int* nr, int* a_k, unsigned* a_mask,
    unsigned* a_cmask,
    int* a_state, uint8_t* a_alive, int* b_k, unsigned* b_mask,
    unsigned* b_cmask, int* b_state, uint8_t* b_alive, int* pk, int* ps,
    uint8_t* pa, int* scal, int* acc, int* stats, int* rows, int* alt,
    int* g, int* gagg, int* seg, int B, int C, int W, int E, int n, int CR,
    int lmax, int model, int tiebreak, int T, int passes, int dedup_block,
    int scan, void** out, int* counts) {
  PairArgs p{f,  v1, v2, ro, fr, inv, ret, sm, cf, cv1, cv2, cinv, cps, cb,
             nr, PoolOut{a_k, a_mask, a_cmask, a_state, a_alive},
             PoolOut{b_k, b_mask, b_cmask, b_state, b_alive},
             pk, ps, scal, acc, rows, alt, g, gagg, stats, seg, pa,
             B, C, W, E, n, CR, lmax, model, tiebreak, T, passes,
             dedup_block, scan};
  const int MW = mask_words(W), MCX = cmask_words(CR);
  const int R = E * (W + 1 + CR) + (C - E);
  for (int i = 0; i < 4; ++i) counts[i] = 0;
  int prep = 0;
  int e = sort_any(rows, alt, scal, B, R, padded_rows(R), 4 + MW + MCX, MW,
                   tiebreak, T, passes, GRANT_ONLY, nullptr, &prep);
  if (!e)
    e = dedup_any(dedup_args(rows, g, gagg, PoolIn{}, PoolOut{}, pk, ps, pa,
                             nr, scal, acc, stats, seg, C, W, CR, R, lmax),
                  B, dedup_block, GRANT_ONLY, nullptr, &prep);
  if (e) return e;
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaStream_t st = nullptr;
  cudaGraphConditionalHandle cond;
  cudaGraphNode_t zero, loop;
  cudaMemsetParams mp = {};
  mp.dst = seg + SEG_RUN;
  mp.value = 0;
  mp.elementSize = sizeof(int);
  mp.width = 1;
  mp.height = 1;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  e = (int)cudaGraphCreate(&graph, 0);
  if (!e)
    e = (int)cudaGraphConditionalHandleCreate(&cond, graph, 1,
                                              cudaGraphCondAssignDefault);
  if (!e) e = (int)cudaGraphAddMemsetNode(&zero, graph, nullptr, 0, &mp);
  if (!e) {
    cp.conditional.handle = cond;
#if CUDART_VERSION >= 13000
    e = (int)cudaGraphAddNode(&loop, graph, &zero, nullptr, 1, &cp);
#else
    e = (int)cudaGraphAddNode(&loop, graph, &zero, 1, &cp);
#endif
  }
  if (!e) e = (int)cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking);
  if (!e) {
    cudaGraph_t body = cp.conditional.phGraph_out[0];
    e = (int)cudaStreamBeginCaptureToGraph(st, body, nullptr, nullptr, 0,
                                           cudaStreamCaptureModeThreadLocal);
    if (!e) {
      const int ce = capture_pair(p, cond, st, counts);
      cudaGraph_t captured = nullptr;
      e = (int)cudaStreamEndCapture(st, &captured);
      if (ce) e = ce;
    }
  }
  if (!e) e = (int)cudaGraphInstantiate(&exec, graph, 0);
  if (st) cudaStreamDestroy(st);
  if (e) {
    if (graph) cudaGraphDestroy(graph);
    cudaGetLastError();
    return e;
  }
  *out = new SegmentGraph{graph, exec};
  return 0;
}

int jt_segment_graph_launch(void* handle, void* stream) {
  const SegmentGraph* sg = (const SegmentGraph*)handle;
  return (int)cudaGraphLaunch(sg->exec, (cudaStream_t)stream);
}

int jt_segment_graph_destroy(void* handle) {
  SegmentGraph* sg = (SegmentGraph*)handle;
  cudaError_t e = cudaGraphExecDestroy(sg->exec);
  const cudaError_t e2 = cudaGraphDestroy(sg->graph);
  delete sg;
  return (int)(e != cudaSuccess ? e : e2);
}

}  // extern "C"
