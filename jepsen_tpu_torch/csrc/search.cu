// One level of the pool linearizability search, as four kernels for Hopper.
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
//          cps [CR], nr (the required-op count, one int per key)
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
// whose condition K5 sets on the device: CUDA 12.3 or later.
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
      *cps;
};

// Key b's columns: [B, n] required, [B, n + 1] sm, [B, CR] crashed.
__device__ __forceinline__ Cols cols_at(const Cols& c, int b, int n, int CR) {
  const size_t q = (size_t)b * n, cq = (size_t)b * CR;
  return Cols{c.f + q,     c.v1 + q,   c.v2 + q,   c.ro + q,
              c.fr + q,    c.inv + q,  c.ret + q,  c.sm + (size_t)b * (n + 1),
              c.cf + cq,   c.cv1 + cq, c.cv2 + cq, c.cinv + cq,
              c.cps + cq};
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
template <int M>
__device__ void fast_forward(int& kk, int& ss, bool go, int bound,
                             const Cols& c, int n, int nr) {
  while (go) {
    const int kc = clampi(kk, 0, n - 1);
    bool ok;
    const int s2 = model_step<M>(ss, c.f[kc], c.v1[kc], c.v2[kc], ok);
    go = c.fr[kc] > 0 && kk < bound && kk < nr && ok;
    if (go) {
      kk += 1;
      ss = s2;
    }
  }
}

// ---------------------------------------------------------------------------
// K1 expand (B1-B4; tpu.py:380-506). Grid (E + tail blocks, B). One
// 128-thread block per expanded row: thread o < W computes required
// candidate o, thread c < CR crashed candidate c; warp w's ballot is word w
// of the closure's pure bits; thread 0 runs the two fast-forwards. Blocks
// past E copy the pool remainder and write the sort's pad rows. Work per
// level is E*(W+CR) model steps per key: at the keyed first rungs a few
// thousand, so the kernel costs its launch. Template parameter M is the
// model; jt_expand instantiates one per model and picks it per launch.
// ---------------------------------------------------------------------------

struct ExpandArgs {
  Cols c;
  PoolIn pool;
  const int* nr;
  int* scal;
  int* acc;
  int* rows;
  int C, W, E, n, CR, MW, MCX, NK, R, RP, lmax;
};

template <int M>
__global__ void __launch_bounds__(128) expand_kernel(ExpandArgs a) {
  const int t = threadIdx.x, b = blockIdx.y;
  const int MW = a.MW, MCX = a.MCX, NK = a.NK, n = a.n;
  int* scal = a.scal + (size_t)b * NSCAL;
  const bool act =
      scal[DONE] == 0 && scal[NALIVE] > 0 && scal[LEVEL] <= a.lmax;
  if (blockIdx.x == 0 && t == 0) scal[ACT] = act;
  if (!act) return;
  const Cols c = cols_at(a.c, b, n, a.CR);
  const PoolIn pool = pool_at(a.pool, b, a.C, MW, MCX);
  int* acc = a.acc + (size_t)b * NACC;
  int* rows = a.rows + (size_t)b * a.RP * NK;
  const int nr = a.nr[b];

  if ((int)blockIdx.x >= a.E) {  // pool remainder, then pad rows
    const int i = (blockIdx.x - a.E) * blockDim.x + t;
    const int nrem = a.C - a.E;
    if (i < nrem) {
      const int p = a.E + i;
      unsigned m[MAXW], cm[MAXW];
      for (int w = 0; w < MW; ++w) m[w] = pool.mask[p * MW + w];
      for (int w = 0; w < MCX; ++w) cm[w] = pool.cmask[p * MCX + w];
      write_row(rows + (size_t)(a.E * (a.W + 1 + a.CR) + i) * NK,
                pool.k[p], m, MW, cm, MCX, pool.state[p],
                pool.alive[p] != 0);
    } else if (i < nrem + (a.RP - a.R)) {
      int* row = rows + (size_t)(a.R + i - nrem) * NK;
      row[0] = PAD_KEY;
      for (int w = 1; w < NK; ++w) row[w] = 0;
    }
    return;
  }

  __shared__ unsigned s_pure[4];
  const int r = blockIdx.x;
  const int ke = pool.k[r];
  const bool ae = pool.alive[r] != 0;
  const int se = pool.state[r];
  unsigned me[MAXW], cme[MAXW];
  for (int w = 0; w < MAXW; ++w) {
    me[w] = w < MW ? pool.mask[r * MW + w] : 0u;
    cme[w] = w < MCX ? pool.cmask[r * MCX + w] : 0u;
  }
  const int retk = c.ret[clampi(ke, 0, n - 1)];
  if (t == 0 && ae) {
    atomicAdd(&acc[A_EXPANDED], 1);
    if (c.sm[clampi(ke + a.W, 0, n)] < retk) atomicOr(&scal[WOVF], 1);
  }

  // the [E, W] required grid: candidate t
  bool pure = false, valid = false;
  int s2 = se;
  if (t < a.W) {
    const int j = ke + t, jc = clampi(j, 0, n - 1);
    const bool cand = ae && j < n && c.inv[jc] < retk && !bit(me, t);
    bool ok;
    s2 = model_step<M>(se, c.f[jc], c.v1[jc], c.v2[jc], ok);
    pure = cand && ok && c.ro[jc] > 0;
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
    const int bound = crash_bound(cme, c, n, a.CR);
    // offset 0: advance the frontier past linearized ops, then fast-forward
    unsigned m1[MAXW], madv[MAXW];
    shr1(me, m1, MW);
    const int t1 = trailing_ones(m1, MW);
    shr_by(m1, t1, madv, MW);
    int kadv = ke + 1 + t1, s0 = s2;
    fast_forward<M>(kadv, s0, valid, bound, c, n, nr);
    write_row(rows + (size_t)(r * a.W) * NK, kadv, madv, MW, cme, MCX, s0,
              valid);
    // the closure successor: every pure candidate at once
    unsigned mc[MAXW], mcl[MAXW];
    for (int w = 0; w < MW; ++w) mc[w] = me[w] | pb[w];
    const int tc = trailing_ones(mc, MW);
    shr_by(mc, tc, mcl, MW);
    int kcl = ke + tc, scl = se;
    fast_forward<M>(kcl, scl, closure_ok, bound, c, n, nr);
    write_row(rows + (size_t)(grid_rows + r) * NK, kcl, mcl, MW, cme, MCX,
              scl, closure_ok);
  } else if (t < a.W) {
    unsigned m2[MAXW];
    for (int w = 0; w < MAXW; ++w) m2[w] = me[w];
    m2[t >> 5] |= 1u << (t & 31);
    write_row(rows + (size_t)(r * a.W + t) * NK, ke, m2, MW, cme, MCX, s2,
              valid);
  }

  // the [E, CR] crashed grid with the canonical-order prune: crash t
  if (t < a.CR) {
    const int ci = t, cp = c.cps[ci];
    const int prevc = clampi(cp, 0, a.CR - 1);
    const bool redundant =
        cp >= 0 && c.cinv[prevc] < retk && !bit(cme, prevc);
    const bool ccand = ae && !closure_ok && c.cinv[ci] < retk &&
                       !bit(cme, ci) && !redundant;
    bool cok;
    const int cs2 = model_step<M>(se, c.cf[ci], c.cv1[ci], c.cv2[ci], cok);
    unsigned ccm[MAXW];
    for (int w = 0; w < MAXW; ++w) ccm[w] = cme[w];
    ccm[ci >> 5] |= 1u << (ci & 31);
    write_row(rows + (size_t)(grid_rows + a.E + r * a.CR + ci) * NK, ke, me,
              MW, ccm, MCX, cs2, ccand && cok && cs2 != se);
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
// index of row i's group start, per key. A warp-shuffle max-scan per
// 1024-row block, then, beyond one block, a second launch adds the carry of
// the key's blocks before. Grid (blocks, B). Reads (3 + MW) words a row;
// bytes-bound on the wide rungs.
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
  const int b = blockIdx.y;
  if (scal[(size_t)b * NSCAL + ACT] == 0) return;
  rows += (size_t)b * RP * NK;
  g += (size_t)b * RP;
  gagg += (size_t)b * gridDim.x;
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
                                  int RP, int blocks) {
  const int b = blockIdx.y;
  if (scal[(size_t)b * NSCAL + ACT] == 0) return;
  g += (size_t)b * RP;
  gagg += (size_t)b * blocks;
  __shared__ int carry;
  const int q0 = blockIdx.x + 1;
  if (threadIdx.x == 0) {
    int c = 0;
    for (int q = 0; q < q0; ++q) c = max(c, gagg[q]);
    carry = c;
  }
  __syncthreads();
  const int i = q0 * blockDim.x + threadIdx.x;
  if (i < RP) g[i] = max(g[i], carry);
}

// ---------------------------------------------------------------------------
// K4 dedup_truncate (B6-B7; tpu.py:589-664). Grid (row blocks, B), one
// thread per row: the adjacent-duplicate test, the 8-leader subset-dominance
// test from the group start, and the first-C truncation into the other pool
// buffer. Warp reductions feed the key's accumulators; the last block of
// the key to finish (a ticket per key) writes its stats row and scalars and
// zeroes its accumulators. While a key is inactive its blocks copy its pool
// through unchanged: the per-lane masked update of tpu.py:652-654.
// ---------------------------------------------------------------------------

struct DedupArgs {
  const int* rows;
  const int* g;
  PoolIn pin;
  PoolOut pout;
  int* pk;
  int* ps;
  uint8_t* pa;
  const int* nr;
  int* scal;
  int* acc;
  int* stats;
  int C, MW, MCX, NK, CR, R, RP, lmax;
};

__global__ void __launch_bounds__(256) dedup_kernel(DedupArgs a) {
  const int t = threadIdx.x, b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + t;
  const int MW = a.MW, MCX = a.MCX, NK = a.NK, C = a.C;
  const PoolIn pin = pool_at(a.pin, b, C, MW, MCX);
  const PoolOut pout = pool_at(a.pout, b, C, MW, MCX);
  int* scal = a.scal + (size_t)b * NSCAL;
  if (scal[ACT] == 0) {
    if (i < C) {
      pout.k[i] = pin.k[i];
      for (int w = 0; w < MW; ++w) pout.mask[i * MW + w] = pin.mask[i * MW + w];
      for (int w = 0; w < MCX; ++w)
        pout.cmask[i * MCX + w] = pin.cmask[i * MCX + w];
      pout.state[i] = pin.state[i];
      pout.alive[i] = pin.alive[i];
    }
    return;
  }
  const int* rows = a.rows + (size_t)b * a.RP * NK;
  const int* g = a.g + (size_t)b * a.RP;
  int* acc = a.acc + (size_t)b * NACC;
  const int nr = a.nr[b];

  bool fv = false, dup = false, dom = false, uniq = false;
  int fk = 0;
  if (i < a.R) {
    const int* ri = rows + (size_t)i * NK;
    fv = ri[0] <= MAXK;
    fk = ri[1];
    bool cm_eq = i > 0;
    for (int w = 0; w < MCX && cm_eq; ++w)
      cm_eq = ri[4 + MW + w] == ri[4 + MW + w - NK];
    dup = cm_eq && same_grp(rows, i, NK, MW);
    if (a.CR > 0 && fv) {
      const int gi = g[i];
      for (int p = 0; p < LEADERS && !dom; ++p) {
        const int li = min(gi + p, a.R - 1);
        if (li >= i) break;
        const int* rl = rows + (size_t)li * NK;
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
  if (i < C) {
    const int* ri = rows + (size_t)i * NK;
    pout.k[i] = ri[1];
    for (int w = 0; w < MW; ++w) pout.mask[i * MW + w] = (unsigned)ri[2 + w];
    for (int w = 0; w < MCX; ++w)
      pout.cmask[i * MCX + w] = (unsigned)ri[4 + MW + w];
    pout.state[i] = ri[2 + MW];
    pout.alive[i] = uniq;
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
  if (last && t == 0) {
    __threadfence();
    volatile int* vacc = acc;
    const int level = scal[LEVEL];
    int* srow = a.stats + ((size_t)b * (a.lmax + 1) + clampi(level, 0, a.lmax))
                              * NSTAT;
    srow[0] = vacc[A_EXPANDED];
    srow[1] = vacc[A_DUP];
    srow[2] = vacc[A_DOM];
    srow[3] = vacc[A_TRUNC];
    srow[4] = vacc[A_FRONTIER];
    scal[DONE] |= vacc[A_DONE];
    scal[LOSSY] |= vacc[A_LOSSY];
    scal[LEVEL] = level + 1;
    scal[BEST] = max(scal[BEST], (int)vacc[A_BEST]);
    scal[NALIVE] = vacc[A_FRONTIER];
    for (int q = 0; q < NACC; ++q) vacc[q] = 0;
  }
}

// ---------------------------------------------------------------------------
// K5 seg_active (B9: active at tpu.py:368-369, seg_active at :681-682, the
// condition of the reference's lax.while_loop(seg_active, body_n, carry)).
// One block, after each level pair of a segment: it adds the levels the
// pair ran to the segment's counter (the first always ran, the host
// launches only an active search; the second ran if some key's K1 found
// it active), then decides whether any key is still active (not done,
// rows alive, the level budget not spent) and the segment is under its
// bound. In a graph it sets the WHILE node's condition; standing alone it
// only writes the flag. Reads B x 32 bytes of scalars: its time is a
// launch.
// ---------------------------------------------------------------------------

enum { SEG_RUN, SEG_BOUND, SEG_GO, NSEG = 4 };

__global__ void __launch_bounds__(256)
    seg_active_kernel(const int* scal, int B, int lmax, int* seg,
                      cudaGraphConditionalHandle cond, int in_graph) {
  int act = 0, ran = 0;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int* s = scal + (size_t)b * NSCAL;
    act |= s[DONE] == 0 && s[NALIVE] > 0 && s[LEVEL] <= lmax;
    ran |= s[ACT] != 0;
  }
  act = __syncthreads_or(act);
  ran = __syncthreads_or(ran);
  if (threadIdx.x == 0) {
    const int run = seg[SEG_RUN] + 1 + (ran != 0);
    const int go = act != 0 && run < seg[SEG_BOUND];
    seg[SEG_RUN] = run;
    seg[SEG_GO] = go;
    if (in_graph) cudaGraphSetConditional(cond, go);
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

// What a call of sort_rows_m does: grant the kernels' shared memory and
// launch them; only grant it (before a graph capture begins); or only
// launch (inside the capture, where the grant was made before).
enum { SORT_ALL, SORT_PREPARE, SORT_CAPTURE };

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
  if (mode != SORT_CAPTURE) {
    cudaError_t e = allow_smem(sort_tile_kernel<TB, M>, tile_smem);
    if (e == cudaSuccess && passes > 0)
      e = allow_smem(sort_merge_kernel<TB, M>, merge_smem);
    if (e != cudaSuccess || mode == SORT_PREPARE) return (int)e;
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

// B9: one segment of levels as a CUDA graph. A memset node zeroes the
// segment's level counter, then a WHILE conditional node (its condition 1
// at each launch) runs its body until K5 clears the condition: the body
// is a level pair, pool A into pool B, then B back into A, then K5, so
// the pool pointers are where they started after every iteration and
// the host's buffers need no swap. The body is captured from the same
// launch functions as the single-level entry points; K2's shared-memory
// grant is made before the capture begins.
struct SegmentGraph {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
};

// The level pair and K5 captured into `body` on stream st.
struct PairArgs {
  const int *f, *v1, *v2, *ro, *fr, *inv, *ret, *sm, *cf, *cv1, *cv2, *cinv,
      *cps, *nr;
  PoolOut a, b;
  int *pk, *ps, *scal, *acc, *rows, *alt, *g, *gagg, *stats, *seg;
  uint8_t* pa;
  int B, C, W, E, n, CR, lmax, model, tiebreak, T, passes;
};

}  // namespace

extern "C" int jt_expand(const int*, const int*, const int*, const int*,
                         const int*, const int*, const int*, const int*,
                         const int*, const int*, const int*, const int*,
                         const int*, const int*, const int*, const unsigned*,
                         const unsigned*, const int*, const uint8_t*, int*,
                         int*, int*, int, int, int, int, int, int, int, int,
                         void*, int*);
extern "C" int jt_group_scan(const int*, const int*, int*, int*, int, int,
                             int, int, void*, int*);
extern "C" int jt_dedup_truncate(const int*, const int*, const int*,
                                 const unsigned*, const unsigned*, const int*,
                                 const uint8_t*, int*, unsigned*, unsigned*,
                                 int*, uint8_t*, int*, int*, uint8_t*,
                                 const int*, int*, int*, int*, int, int, int,
                                 int, int, int, void*, int*);

namespace {

// Captures one level pair and K5 on st; counts[0..4] take the CUDA
// launches of K1, K2, K3, K4 and K5.
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
                      p.cv1, p.cv2, p.cinv, p.cps, p.nr, in.k, in.mask,
                      in.cmask, in.state, in.alive, p.scal, p.acc, p.rows,
                      p.B, p.C, p.W, p.E, p.n, p.CR, p.lmax, p.model, st,
                      &counts[0]);
    if (!e)
      e = sort_any(p.rows, p.alt, p.scal, p.B, R, RP, NK, MW, p.tiebreak,
                   p.T, p.passes, SORT_CAPTURE, st, &counts[1]);
    if (!e)
      e = jt_group_scan(p.rows, p.scal, p.g, p.gagg, p.B, RP, NK, MW, st,
                        &counts[2]);
    if (!e)
      e = jt_dedup_truncate(p.rows, p.g, in.k, in.mask, in.cmask, in.state,
                            in.alive, out.k, out.mask, out.cmask, out.state,
                            out.alive, p.pk, p.ps, p.pa, p.nr, p.scal, p.acc,
                            p.stats, p.B, p.C, p.W, p.CR, R, p.lmax, st,
                            &counts[3]);
    if (e) return e;
  }
  seg_active_kernel<<<1, 256, 0, st>>>(p.scal, p.B, p.lmax, p.seg, cond, 1);
  ++counts[4];
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int jt_expand(const int* f, const int* v1, const int* v2, const int* ro,
              const int* fr, const int* inv, const int* ret, const int* sm,
              const int* cf, const int* cv1, const int* cv2, const int* cinv,
              const int* cps, const int* nr, const int* k,
              const unsigned* mask, const unsigned* cmask, const int* state,
              const uint8_t* alive, int* scal, int* acc, int* rows, int B,
              int C, int W, int E, int n, int CR, int lmax, int model,
              void* stream, int* launched) {
  if (model < 0 || model >= NMODELS) return (int)cudaErrorInvalidValue;
  ExpandArgs a;
  a.c = Cols{f, v1, v2, ro, fr, inv, ret, sm, cf, cv1, cv2, cinv, cps};
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
  const int tail = (C - E) + (a.RP - a.R);
  const dim3 grid(E + (tail + 127) / 128, B);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (model) {
    case M_MUTEX: expand_kernel<M_MUTEX><<<grid, 128, 0, st>>>(a); break;
    case M_NOOP: expand_kernel<M_NOOP><<<grid, 128, 0, st>>>(a); break;
    case M_SET: expand_kernel<M_SET><<<grid, 128, 0, st>>>(a); break;
    case M_UQUEUE: expand_kernel<M_UQUEUE><<<grid, 128, 0, st>>>(a); break;
    case M_FIFO: expand_kernel<M_FIFO><<<grid, 128, 0, st>>>(a); break;
    default: expand_kernel<M_CAS><<<grid, 128, 0, st>>>(a); break;
  }
  ++*launched;
  return (int)cudaGetLastError();
}

int jt_sort_rows(int* rows, int* alt, const int* scal, int B, int R, int RP,
                 int NK, int MW, int tiebreak, int T, int passes, void* stream,
                 int* launched) {
  return sort_any(rows, alt, scal, B, R, RP, NK, MW, tiebreak, T, passes,
                  SORT_ALL, (cudaStream_t)stream, launched);
}

int jt_group_scan(const int* rows, const int* scal, int* g, int* gagg, int B,
                  int RP, int NK, int MW, void* stream, int* launched) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = RP < 1024 ? (RP < 32 ? 32 : RP) : 1024;
  const int blocks = RP < 1024 ? 1 : RP / 1024;
  scan_local_kernel<<<dim3(blocks, B), threads, 0, st>>>(rows, scal, g, gagg,
                                                         RP, NK, MW);
  ++*launched;
  if (blocks > 1) {
    scan_carry_kernel<<<dim3(blocks - 1, B), threads, 0, st>>>(scal, g, gagg,
                                                               RP, blocks);
    ++*launched;
  }
  return (int)cudaGetLastError();
}

int jt_dedup_truncate(const int* rows, const int* g, const int* in_k,
                      const unsigned* in_mask, const unsigned* in_cmask,
                      const int* in_state, const uint8_t* in_alive,
                      int* out_k, unsigned* out_mask, unsigned* out_cmask,
                      int* out_state, uint8_t* out_alive, int* pk, int* ps,
                      uint8_t* pa, const int* nr, int* scal, int* acc,
                      int* stats, int B, int C, int W, int CR, int R,
                      int lmax, void* stream, int* launched) {
  DedupArgs a;
  a.rows = rows;
  a.g = g;
  a.pin = PoolIn{in_k, in_mask, in_cmask, in_state, in_alive};
  a.pout = PoolOut{out_k, out_mask, out_cmask, out_state, out_alive};
  a.pk = pk;
  a.ps = ps;
  a.pa = pa;
  a.nr = nr;
  a.scal = scal;
  a.acc = acc;
  a.stats = stats;
  a.C = C;
  a.MW = mask_words(W);
  a.MCX = cmask_words(CR);
  a.NK = 4 + a.MW + a.MCX;
  a.CR = CR;
  a.R = R;
  a.RP = padded_rows(R);
  a.lmax = lmax;
  dedup_kernel<<<dim3((R + 255) / 256, B), 256, 0, (cudaStream_t)stream>>>(a);
  ++*launched;
  return (int)cudaGetLastError();
}

int jt_seg_active(const int* scal, int* seg, int B, int lmax, void* stream,
                  int* launched) {
  seg_active_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(
      scal, B, lmax, seg, cudaGraphConditionalHandle(), 0);
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
// bound, go). Writes the graph's handle to *out and the CUDA launches
// one iteration of its body makes, per kernel K1..K5, to counts[0..4].
int jt_segment_graph_create(
    const int* f, const int* v1, const int* v2, const int* ro, const int* fr,
    const int* inv, const int* ret, const int* sm, const int* cf,
    const int* cv1, const int* cv2, const int* cinv, const int* cps,
    const int* nr, int* a_k, unsigned* a_mask, unsigned* a_cmask,
    int* a_state, uint8_t* a_alive, int* b_k, unsigned* b_mask,
    unsigned* b_cmask, int* b_state, uint8_t* b_alive, int* pk, int* ps,
    uint8_t* pa, int* scal, int* acc, int* stats, int* rows, int* alt,
    int* g, int* gagg, int* seg, int B, int C, int W, int E, int n, int CR,
    int lmax, int model, int tiebreak, int T, int passes, void** out,
    int* counts) {
  PairArgs p{f,  v1, v2, ro, fr, inv, ret, sm, cf, cv1, cv2, cinv, cps, nr,
             PoolOut{a_k, a_mask, a_cmask, a_state, a_alive},
             PoolOut{b_k, b_mask, b_cmask, b_state, b_alive},
             pk, ps, scal, acc, rows, alt, g, gagg, stats, seg, pa,
             B, C, W, E, n, CR, lmax, model, tiebreak, T, passes};
  const int MW = mask_words(W), MCX = cmask_words(CR);
  const int R = E * (W + 1 + CR) + (C - E);
  for (int i = 0; i < 5; ++i) counts[i] = 0;
  int prep = 0;
  int e = sort_any(rows, alt, scal, B, R, padded_rows(R), 4 + MW + MCX, MW,
                   tiebreak, T, passes, SORT_PREPARE, nullptr, &prep);
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
