// Native WGL linearizability engine over packed integer-kernel histories.
//
// This is the C++ twin of jepsen_tpu_torch/checker/wgl.py::check_packed —
// the same Wing-Gong-Lowe frontier search the reference outsources to
// knossos (jepsen/project.clj:9, algorithms selected at checker.clj:85-94),
// over the same (k, mask, state) canonical configurations and the same
// reductions (greedy pure-op closure, crashed no-effect rule). It exists
// for the host side of the checker: the GPU path batches thousands of
// configurations per level, but single-history CPU checking — the
// competition racer, the WGL differential oracle, checks run without a
// GPU — was interpreter-bound. One contract keeps the engines honest:
// identical verdicts on every history (tests/test_torch_native.py holds
// native against the Python search and the JAX package's engine).
//
// Representation notes (equivalent to the Python search, not identical):
// * the Python mask is one arbitrary-precision int over offsets j-k for
//   required AND crashed ops; here required offsets get a fixed-width
//   window mask (Mask<MW>, window = 64*MW bits, MW in {2,4,8}) and
//   crashed ops a 128-bit absolute mask (c0,c1). The mapping is
//   bijective, so the visited-set dedup matches 1:1.
// * offsets past the window (or >128 crashed ops) return UNKNOWN_WINDOW;
//   the wrapper escalates MW 2 -> 4 -> 8 and only then falls back to the
//   unbounded Python search — mirroring how the device search escalates
//   on window overflow (and exceeding its 128 cap: MW=4/8 check shapes
//   the device path can only answer with a found witness).
//
// Built on demand by jepsen_tpu_torch/native/__init__.py (g++ -O2
// -shared), the same compile-on-use pattern as the on-node clock helpers
// (reference nemesis/time.clj:11-27).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// f-codes: jepsen_tpu_torch/models/core.py:288-295 (a test holds
// them equal).
constexpr int32_t F_READ = 0;
constexpr int32_t F_WRITE = 1;
constexpr int32_t F_CAS = 2;
constexpr int32_t F_ACQUIRE = 3;
constexpr int32_t F_RELEASE = 4;
constexpr int32_t F_ADD = 5;
constexpr int32_t F_ENQUEUE = 6;
constexpr int32_t F_DEQUEUE = 7;
constexpr int32_t NIL_ID = -1;

constexpr int KERNEL_CAS_REGISTER = 0;
constexpr int KERNEL_MUTEX = 1;
constexpr int KERNEL_NOOP = 2;
constexpr int KERNEL_SET = 3;
constexpr int KERNEL_UQUEUE = 4;
constexpr int KERNEL_FIFO = 5;

constexpr int64_t VALID = 1;
constexpr int64_t INVALID = 0;
constexpr int64_t UNKNOWN_BUDGET = 2;
constexpr int64_t UNKNOWN_WINDOW = 3;
constexpr int64_t BAD_KERNEL = 4;
constexpr int64_t CANCELLED = 5;

constexpr int CRASH_WINDOW = 128; // crashed absolute mask width
constexpr int FIFO_SLOTS = 7;

// --- integer kernels: models/core.py cas_register_step .. fifo_step -------

template <int K>
inline bool step(int32_t s, int32_t fc, int32_t v1, int32_t v2,
                 int32_t* s2) {
  if constexpr (K == KERNEL_CAS_REGISTER) {
    if (fc == F_READ) { *s2 = s; return v1 == NIL_ID || s == v1; }
    if (fc == F_WRITE) { *s2 = v1; return true; }
    if (fc == F_CAS) { *s2 = (s == v1) ? v2 : s; return s == v1; }
    *s2 = s; return false;
  } else if constexpr (K == KERNEL_MUTEX) {
    if (fc == F_ACQUIRE) { *s2 = 1; return s == 0; }
    if (fc == F_RELEASE) { *s2 = 0; return s == 1; }
    *s2 = s; return false;
  } else if constexpr (K == KERNEL_NOOP) {
    *s2 = s; return true;
  } else if constexpr (K == KERNEL_SET) {
    if (fc == F_ADD) {
      int32_t unit = v1 >= 0 ? v1 : 0;
      *s2 = (v2 == 1) ? s + unit : (s | unit);
      return true;
    }
    *s2 = s;
    return v1 == NIL_ID || s == v1;  // read
  } else if constexpr (K == KERNEL_UQUEUE) {
    int32_t sh = v1 >= 0 ? v1 : 0;
    int32_t unit = int32_t(1) << sh;
    int32_t cnt = (s >> sh) & v2;
    if (fc == F_ENQUEUE) { *s2 = (v2 > 0) ? s + unit : s; return true; }
    bool deq_ok = (fc == F_DEQUEUE) && v1 >= 0 && cnt > 0;
    *s2 = deq_ok ? s - unit : s;
    return deq_ok;
  } else if constexpr (K == KERNEL_FIFO) {
    int length = 0;
    for (int i = 0; i < FIFO_SLOTS; ++i)
      if ((s >> (4 * i)) & 15) ++length;
    if (fc == F_ENQUEUE) {
      bool ok = length < FIFO_SLOTS;
      *s2 = ok ? (s | (v1 << (4 * length))) : s;
      return ok;
    }
    bool deq_ok = (fc == F_DEQUEUE) && v1 > 0 && (s & 15) == v1;
    *s2 = deq_ok ? (s >> 4) : s;
    return deq_ok;
  }
  *s2 = s;
  return false;
}

// Pure-op predicate: the step can never change the state at ANY state
// where it succeeds (KernelSpec.readonly, models/core.py:914-967).
template <int K>
inline bool readonly_op(int32_t fc, int32_t v1, int32_t v2) {
  if constexpr (K == KERNEL_CAS_REGISTER)
    return fc == F_READ || (fc == F_CAS && v1 == v2);
  else if constexpr (K == KERNEL_NOOP)
    return true;
  else if constexpr (K == KERNEL_SET)
    return fc == F_READ;
  else if constexpr (K == KERNEL_UQUEUE)
    return fc == F_ENQUEUE && v2 == 0;  // sink enqueue
  else
    return false;
}

// --- configuration + visited set -----------------------------------------
//
// The required-candidate mask is templated on its word count MW (window
// = 64*MW offsets): MW=2 covers every realistic concurrency (and is
// what the device search supports), MW=4/8 extend EXACT native checking
// to 256/512-wide histories the device path can only answer with a
// witness. The wrapper escalates MW on UNKNOWN_WINDOW, so narrow
// histories never pay for wide configs.

template <int MW>
struct Mask {
  uint64_t w[MW];

  bool operator==(const Mask& o) const {
    for (int i = 0; i < MW; ++i)
      if (w[i] != o.w[i]) return false;
    return true;
  }
  bool any() const {
    uint64_t x = 0;
    for (int i = 0; i < MW; ++i) x |= w[i];
    return x != 0;
  }
  bool get(int off) const { return (w[off >> 6] >> (off & 63)) & 1; }
  void set(int off) { w[off >> 6] |= 1ull << (off & 63); }
  void orwith(const Mask& o) {
    for (int i = 0; i < MW; ++i) w[i] |= o.w[i];
  }
  void shr1() {
    for (int i = 0; i < MW - 1; ++i)
      w[i] = (w[i] >> 1) | (w[i + 1] << 63);
    w[MW - 1] >>= 1;
  }
  // Consume contiguous leading ones; returns how many were consumed.
  int advance() {
    int adv = 0;
    while (w[0] & 1) {
      shr1();
      ++adv;
    }
    return adv;
  }
};

template <int MW>
struct Cfg {
  int32_t k;
  int32_t state;
  Mask<MW> m;          // required-candidate mask, offsets j-k
  uint64_t c0, c1;     // crashed mask, absolute index j-n_req in [0,128)

  bool operator==(const Cfg& o) const {
    return k == o.k && state == o.state && m == o.m && c0 == o.c0 &&
           c1 == o.c1;
  }
};

inline uint64_t mix(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

template <int MW>
inline uint64_t cfg_hash(const Cfg<MW>& c) {
  uint64_t h = mix((uint64_t(uint32_t(c.k)) << 32) | uint32_t(c.state));
  for (int i = 0; i < MW; ++i) h = mix(h ^ c.m.w[i]);
  h = mix(h ^ c.c0);
  return mix(h ^ c.c1);
}

// Open-addressing visited set (linear probing, power-of-two capacity).
template <int MW>
class Seen {
 public:
  explicit Seen(size_t cap = 1 << 14) { rehash(cap); }

  // Insert; returns true if newly added.
  bool add(const Cfg<MW>& c) {
    if ((count_ + 1) * 10 >= cap_ * 7) rehash(cap_ * 2);
    size_t i = cfg_hash(c) & (cap_ - 1);
    while (slots_[i].k != -1) {
      if (slots_[i] == c) return false;
      i = (i + 1) & (cap_ - 1);
    }
    slots_[i] = c;
    ++count_;
    return true;
  }

 private:
  void rehash(size_t cap) {
    std::vector<Cfg<MW>> old = std::move(slots_);
    cap_ = cap;
    Cfg<MW> empty{};
    empty.k = -1;
    slots_.assign(cap_, empty);
    count_ = 0;
    for (const Cfg<MW>& c : old)
      if (c.k != -1) {
        size_t i = cfg_hash(c) & (cap_ - 1);
        while (slots_[i].k != -1) i = (i + 1) & (cap_ - 1);
        slots_[i] = c;
        ++count_;
      }
  }

  std::vector<Cfg<MW>> slots_;
  size_t cap_ = 0;
  size_t count_ = 0;
};

struct Search {
  const int32_t *f, *v1, *v2, *inv, *ret;
  int32_t n, n_req;
  int32_t init_state;
  uint64_t max_configs;
  const volatile uint8_t* stop;

  uint64_t explored = 0;
  int32_t best_k = 0;
  int32_t best_states[16];
  int n_best = 0;

  // minv_suffix[j] = min(inv[j..n_req-1]); detects required candidates
  // beyond the representable window in O(1) per pop.
  std::vector<int32_t> minv_suffix;

  void note_best(int32_t k, int32_t state) {
    if (k > best_k) {
      best_k = k;
      best_states[0] = state;
      n_best = 1;
    } else if (k == best_k && n_best < 16) {
      for (int i = 0; i < n_best; ++i)
        if (best_states[i] == state) return;
      best_states[n_best++] = state;
    }
  }
};

template <int K, int MW>
int64_t run(Search& S) {
  constexpr int kWindow = 64 * MW;
  S.minv_suffix.assign(size_t(S.n_req) + 1, INT32_MAX);
  for (int32_t j = S.n_req - 1; j >= 0; --j)
    S.minv_suffix[j] = S.inv[j] < S.minv_suffix[j + 1] ? S.inv[j]
                                                       : S.minv_suffix[j + 1];
  if (S.n - S.n_req > CRASH_WINDOW) return UNKNOWN_WINDOW;

  std::vector<Cfg<MW>> stack;
  Seen<MW> seen;
  Cfg<MW> init{};
  init.state = S.init_state;
  S.note_best(0, init.state);
  stack.push_back(init);
  seen.add(init);

  // successor scratch: (j, s2) pairs for impure candidates
  int32_t imp_j[kWindow + CRASH_WINDOW];
  int32_t imp_s[kWindow + CRASH_WINDOW];

  while (!stack.empty()) {
    Cfg<MW> c = stack.back();
    stack.pop_back();
    ++S.explored;
    if (S.max_configs && S.explored > S.max_configs) return UNKNOWN_BUDGET;
    if (S.stop && (S.explored & 1023) == 0 && *S.stop) return CANCELLED;

    const int32_t rk = S.ret[c.k];
    // required candidates past the representable window?
    if (c.k + kWindow < S.n_req && S.minv_suffix[c.k + kWindow] < rk)
      return UNKNOWN_WINDOW;

    Mask<MW> pure{};
    int n_imp = 0;
    const int32_t jmax =
        (S.n_req < c.k + kWindow ? S.n_req : c.k + kWindow);
    for (int32_t j = c.k; j < jmax; ++j) {
      if (S.inv[j] >= rk) continue;
      const int off = j - c.k;
      if (c.m.get(off)) continue;
      int32_t s2;
      if (!step<K>(c.state, S.f[j], S.v1[j], S.v2[j], &s2)) continue;
      if (readonly_op<K>(S.f[j], S.v1[j], S.v2[j]))
        pure.set(off);
      else {
        imp_j[n_imp] = j;
        imp_s[n_imp++] = s2;
      }
    }
    if (!pure.any()) {
      // crashed (optional) candidates, skipped entirely under a pure
      // closure — the closure successor ignores impure candidates too.
      for (int32_t j = S.n_req; j < S.n; ++j) {
        if (S.inv[j] >= rk) continue;
        const int coff = j - S.n_req;
        if ((coff < 64 ? (c.c0 >> coff) : (c.c1 >> (coff - 64))) & 1)
          continue;
        int32_t s2;
        if (!step<K>(c.state, S.f[j], S.v1[j], S.v2[j], &s2)) continue;
        if (s2 == c.state) continue;  // no-effect crashed op: never take
        imp_j[n_imp] = j;
        imp_s[n_imp++] = s2;
      }
    }

    if (pure.any()) {
      Cfg<MW> s = c;
      s.m.orwith(pure);
      s.k += s.m.advance();
      S.note_best(s.k, s.state);
      if (s.k >= S.n_req) return VALID;
      if (seen.add(s)) stack.push_back(s);
      continue;
    }
    for (int i = 0; i < n_imp; ++i) {
      const int32_t j = imp_j[i];
      Cfg<MW> s = c;
      s.state = imp_s[i];
      if (j >= S.n_req) {
        const int coff = j - S.n_req;
        if (coff < 64)
          s.c0 |= 1ull << coff;
        else
          s.c1 |= 1ull << (coff - 64);
      } else if (j == c.k) {
        s.m.shr1();
        s.k += 1 + s.m.advance();
      } else {
        s.m.set(j - c.k);
      }
      S.note_best(s.k, s.state);
      if (s.k >= S.n_req) return VALID;
      if (seen.add(s)) stack.push_back(s);
    }
  }
  return INVALID;
}

template <int MW>
int64_t run_kernel(int32_t kernel_id, Search& S) {
  switch (kernel_id) {
    case KERNEL_CAS_REGISTER: return run<KERNEL_CAS_REGISTER, MW>(S);
    case KERNEL_MUTEX: return run<KERNEL_MUTEX, MW>(S);
    case KERNEL_NOOP: return run<KERNEL_NOOP, MW>(S);
    case KERNEL_SET: return run<KERNEL_SET, MW>(S);
    case KERNEL_UQUEUE: return run<KERNEL_UQUEUE, MW>(S);
    case KERNEL_FIFO: return run<KERNEL_FIFO, MW>(S);
    default: return BAD_KERNEL;
  }
}

}  // namespace

extern "C" {

// out: [explored, best_k, n_states, states[0..15]] (19 slots).
// mask_words selects the required-offset window (64*mask_words): 2, 4,
// or 8. Returns VALID/INVALID/UNKNOWN_BUDGET/UNKNOWN_WINDOW/BAD_KERNEL/
// CANCELLED; on UNKNOWN_WINDOW the caller escalates mask_words.
int64_t jepsen_wgl_check(int32_t kernel_id, int32_t mask_words,
                         int32_t init_state, int32_t n, int32_t n_req,
                         const int32_t* f, const int32_t* v1,
                         const int32_t* v2, const int32_t* inv,
                         const int32_t* ret, uint64_t max_configs,
                         const volatile uint8_t* stop, int64_t* out) {
  Search S;
  S.f = f;
  S.v1 = v1;
  S.v2 = v2;
  S.inv = inv;
  S.ret = ret;
  S.n = n;
  S.n_req = n_req;
  S.init_state = init_state;
  S.max_configs = max_configs;
  S.stop = stop;

  int64_t status;
  switch (mask_words) {
    case 2: status = run_kernel<2>(kernel_id, S); break;
    case 4: status = run_kernel<4>(kernel_id, S); break;
    case 8: status = run_kernel<8>(kernel_id, S); break;
    default: return BAD_KERNEL;
  }
  out[0] = int64_t(S.explored);
  out[1] = S.best_k;
  out[2] = S.n_best;
  for (int i = 0; i < S.n_best; ++i) out[3 + i] = S.best_states[i];
  return status;
}

// ABI version, checked by checker/native.py before prototyping the entry
// point — a stale cached .so from an older ABI is refused, not called.
int64_t jepsen_wgl_abi_version(void) { return 2; }

}  // extern "C"
