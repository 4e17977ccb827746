// Backward of a 1-D max pool along the middle axis of [P, N, Q].
//
// Replaces the TPU kernel coclr_tpu/ops/pallas_pool.py::pool1d_bwd (kernel
// body _bwd_kernel). Same contract: x [P, N, Q] pooled along N with window k,
// stride s and symmetric -inf padding lo; out and g are [P, M, Q]. Each window
// sends its g to the FIRST tap whose x equals the window's max (none if no
// tap does), which is what XLA's select_and_scatter does; a tap's windows are
// added in increasing tap offset d, in float32, and dx [P, N, Q] is cast to
// x's dtype once.
//
// What bounds it on an H100: bytes. x, out and g are read once and dx is
// written once; per element there are a few compares and adds.
//
// The first design (one thread per element of x) was held by instructions,
// not bytes: each thread split a 64-bit flat index with four 64-bit divides,
// rescanned all k taps of every window covering its element (so each
// window's argmax was found up to ceil(k/s) times), and moved 2-byte scalars.
//
// This design: one block takes a tile of Pt whole [N, Q] planes (Pt * N * Q
// consecutive elements of x, Pt * M * Q of out and g), or, where one plane
// exceeds the shared-memory budget, a tile of Qt columns of one plane. The
// wrapper (kernels/pool.py::plan) picks the tile.
//  - Staging: x, out and g of the tile go into shared memory with 16-byte
//    cp.async copies, all in flight at once, when every run of the tile is
//    16-byte aligned (the wrapper picks Pt to make it so); element copies
//    otherwise. Several blocks per SM overlap one block's copies with
//    another's work.
//  - Phase A: one thread per (plane, window, q) finds the window's first
//    maximal tap once (k float32 compares in shared memory) and keeps it as
//    int8 in shared memory.
//  - Phase B: one thread per (plane, i, q) walks the at most ceil(k/s)
//    windows covering i in increasing d, adds g where the window's tap is d,
//    and writes dx over x's slot in shared memory; a last pass copies the
//    tile out with 16-byte stores. No atomics; the order of the sums is the
//    plain version's, so the result is bit-exact.
//  - Each thread takes VQ consecutive columns at once (up to 16 bytes,
//    VQ dividing Q), so each shared-memory access moves VQ elements: the
//    shared-memory pipe issues one access per warp and cycle whatever its
//    width, and 2-byte accesses left it the bottleneck.
//  - Q == 1 (a pool along the innermost axis): the tile's Pt planes are
//    staged transposed, as the Pt columns of one [N, Pt] plane, so the same
//    phases take VQ planes at once; the copies move 16 bytes of a plane per
//    thread through registers instead of cp.async.
//  - Index math is 32-bit within the tile, with divisions by N, M, Qt and s
//    as a multiply-high and a shift (FastDiv), or shifts where k and s are
//    the compile-time values of S3D's pools; the only 64-bit arithmetic is
//    each block's base offset.

#include <type_traits>

#include "common.cuh"

namespace {

using coclr::FastDiv;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // independent elements per thread and step

template <typename T>
struct PoolArgs {
  const T* x;
  const T* out;
  const T* g;
  T* dx;
  long long p;
  int n, m, q, k, s, lo;
  int pt;       // planes per block
  int qt;       // columns per block: q for whole planes
  int vec;      // 1: every run of every tile is 16-byte aligned
  FastDiv div_qtiles, div_qt, div_qtv, div_n, div_m, div_s;
  FastDiv div_units;  // vector units per row of the tile in shared memory
  FastDiv div_pt;
};

template <int B>
struct Raw;  // an unsigned type of B bytes
template <>
struct Raw<1> { using type = uint8_t; };
template <>
struct Raw<2> { using type = uint16_t; };
template <>
struct Raw<4> { using type = uint32_t; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

// VQ consecutive elements of T (or int8) in shared memory, as one load or
// store of VQ * sizeof(T) bytes; the element bits are converted by hand.
template <typename T>
using Bits = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;

template <typename T, int VQ>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VQ]) {
  union {
    typename Raw<VQ * sizeof(T)>::type raw;
    Bits<T> e[VQ];
  } u;
  u.raw = *reinterpret_cast<const typename Raw<VQ * sizeof(T)>::type*>(p);
#pragma unroll
  for (int l = 0; l < VQ; ++l) {
    v[l] = __uint_as_float(sizeof(T) == 2 ? static_cast<uint32_t>(u.e[l]) << 16 : u.e[l]);
  }
}

template <typename T, int VQ>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VQ]) {
  union {
    typename Raw<VQ * sizeof(T)>::type raw;
    Bits<T> e[VQ];
  } u;
#pragma unroll
  for (int l = 0; l < VQ; ++l) {
    if constexpr (sizeof(T) == 2) {
      u.e[l] = __bfloat16_as_ushort(__float2bfloat16_rn(v[l]));
    } else {
      u.e[l] = __float_as_uint(v[l]);
    }
  }
  *reinterpret_cast<typename Raw<VQ * sizeof(T)>::type*>(p) = u.raw;
}

template <int VQ>
__device__ __forceinline__ void load_taps(const int8_t* p, int (&v)[VQ]) {
  union {
    typename Raw<VQ>::type raw;
    int8_t e[VQ];
  } u;
  u.raw = *reinterpret_cast<const typename Raw<VQ>::type*>(p);
#pragma unroll
  for (int l = 0; l < VQ; ++l) v[l] = u.e[l];
}

template <int VQ>
__device__ __forceinline__ void store_taps(int8_t* p, const int (&v)[VQ]) {
  union {
    typename Raw<VQ>::type raw;
    int8_t e[VQ];
  } u;
#pragma unroll
  for (int l = 0; l < VQ; ++l) u.e[l] = static_cast<int8_t>(v[l]);
  *reinterpret_cast<typename Raw<VQ>::type*>(p) = u.raw;
}

// Copies `rows` rows of `width` valid elements between device memory (row
// stride `gstride`) and shared memory (row stride `sstride`, dense). With
// whole planes the rows are one contiguous run. kLoad: device -> shared by
// cp.async (the caller waits); otherwise shared -> device.
template <bool kLoad, typename T>
__device__ __forceinline__ void copy_tile(T* smem, T* gmem, int rows, int width,
                                          long long gstride, int sstride, bool whole,
                                          bool vec, FastDiv div_sv, FastDiv div_s) {
  constexpr int V = 16 / sizeof(T);
  const auto move = [&](int si, long long gi) {
    if constexpr (kLoad) {
      smem[si] = gmem[gi];
    } else {
      gmem[gi] = smem[si];
    }
  };
  const auto move16 = [&](int si, long long gi) {
    if constexpr (kLoad) {
      coclr::cp_async16(smem + si, gmem + gi);
    } else {
      *reinterpret_cast<uint4*>(gmem + gi) = *reinterpret_cast<const uint4*>(smem + si);
    }
  };
  if (whole) {
    const int len = rows * width;
    int body = 0;
    if (vec) {
      body = len / V * V;
      for (int c = threadIdx.x; c < len / V; c += kThreads) move16(c * V, c * V);
    }
    for (int e = body + threadIdx.x; e < len; e += kThreads) move(e, e);
  } else if (vec) {  // width and the row starts are multiples of V
    const int per_row = sstride / V;
    for (int c = threadIdx.x; c < rows * per_row; c += kThreads) {
      int j;
      const int r = div_sv.divmod(c, j);
      if (j * V < width) move16(r * sstride + j * V, r * gstride + j * V);
    }
  } else {
    for (int e = threadIdx.x; e < rows * sstride; e += kThreads) {
      int j;
      const int r = div_s.divmod(e, j);
      if (j < width) move(e, r * gstride + j);
    }
  }
}

// Copies `planes` planes of `rows` elements (one contiguous run, plane
// stride `rows`) between device memory and a transposed tile in shared
// memory: element (p, r) at r * wq + p. Consecutive threads take consecutive
// planes, so the shared-memory side has no bank conflicts; each thread
// moves 16 bytes of one plane at once where rows and the run allow.
template <bool kLoad, typename T>
__device__ __forceinline__ void copy_transposed(T* smem, T* gmem, int planes, int cap,
                                                int rows, int wq, bool vec,
                                                FastDiv div_cap) {
  constexpr int V = 16 / sizeof(T);
  if (vec && rows % V == 0) {
    const int chunks = rows / V;
#pragma unroll 4
    for (int it = threadIdx.x; it < cap * chunks; it += kThreads) {
      int p;
      const int j = div_cap.divmod(it, p);
      if (p >= planes) continue;
      union {
        uint4 raw;
        Bits<T> e[V];
      } u;
      uint4* g = reinterpret_cast<uint4*>(gmem + p * rows + j * V);
      Bits<T>* t = reinterpret_cast<Bits<T>*>(smem) + j * V * wq + p;
      if constexpr (kLoad) {
        u.raw = *g;
#pragma unroll
        for (int l = 0; l < V; ++l) t[l * wq] = u.e[l];
      } else {
#pragma unroll
        for (int l = 0; l < V; ++l) u.e[l] = t[l * wq];
        *g = u.raw;
      }
    }
  } else {
    for (int it = threadIdx.x; it < cap * rows; it += kThreads) {
      int p;
      const int r = div_cap.divmod(it, p);
      if (p >= planes) continue;
      if constexpr (kLoad) {
        smem[r * wq + p] = gmem[p * rows + r];
      } else {
        gmem[p * rows + r] = smem[r * wq + p];
      }
    }
  }
}

__host__ __device__ __forceinline__ int round16(int bytes) { return (bytes + 15) & ~15; }

// K, S > 0: the window and stride of the configurations S3D uses, fixed at
// compile time so the tap loops unroll; K = S = 0 reads them from `a`. VQ:
// the elements along q that one thread takes at once (VQ divides q and qt),
// so each shared-memory access moves VQ elements. TR (Q == 1, pt a multiple
// of VQ): the tile's pt planes become the columns of one transposed plane in
// shared memory, so the phases take VQ planes at once.
template <typename T, int K, int S, int VQ, bool TR>
__global__ void __launch_bounds__(kThreads) pool1d_bwd_kernel(const PoolArgs<T> a) {
  constexpr int kSteps = VQ >= kUnroll ? 1 : kUnroll / VQ;  // units per thread and step
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = K ? K : a.k, s = S ? S : a.s;
  const int n = a.n, m = a.m, lo = a.lo;
  int qtile;
  const int slab = a.div_qtiles.divmod(blockIdx.x, qtile);
  const long long p0 = static_cast<long long>(slab) * a.pt;
  const int pt = static_cast<int>(min(static_cast<long long>(a.pt), a.p - p0));
  const int q0 = qtile * a.qt;
  // the tile in shared memory: tp planes of [rows, wq], qv valid columns
  const int tp = TR ? 1 : pt, cap = TR ? 1 : a.pt;
  const int wq = TR ? a.pt : a.qt;
  const int qv = TR ? pt : min(a.qt, a.q - q0);
  const int wu = wq / VQ;  // vector units per row
  const bool whole = a.qt == a.q;

  T* xs = reinterpret_cast<T*>(smem);
  T* os = reinterpret_cast<T*>(smem + round16(cap * n * wq * sizeof(T)));
  T* gs = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(os) +
                               round16(cap * m * wq * sizeof(T)));
  int8_t* taps = reinterpret_cast<int8_t*>(gs) + round16(cap * m * wq * sizeof(T));

  const long long xoff = p0 * n * a.q + q0, woff = p0 * m * a.q + q0;
  if constexpr (TR) {
    copy_transposed<true>(xs, const_cast<T*>(a.x) + xoff, pt, a.pt, n, wq, a.vec, a.div_pt);
    copy_transposed<true>(os, const_cast<T*>(a.out) + woff, pt, a.pt, m, wq, a.vec,
                          a.div_pt);
    copy_transposed<true>(gs, const_cast<T*>(a.g) + woff, pt, a.pt, m, wq, a.vec, a.div_pt);
  } else {
    copy_tile<true>(xs, const_cast<T*>(a.x) + xoff, pt * n, qv, a.q, wq, whole, a.vec,
                    a.div_qtv, a.div_qt);
    copy_tile<true>(os, const_cast<T*>(a.out) + woff, pt * m, qv, a.q, wq, whole, a.vec,
                    a.div_qtv, a.div_qt);
    copy_tile<true>(gs, const_cast<T*>(a.g) + woff, pt * m, qv, a.q, wq, whole, a.vec,
                    a.div_qtv, a.div_qt);
    coclr::cp_async_wait_all();
  }
  __syncthreads();

  // Phase A: each window's first maximal tap (-1: none equals the max), for
  // VQ columns at once. Consecutive threads take consecutive units (no bank
  // conflicts), kSteps independent units per thread and step.
  const int n_wu = tp * m * wu;
  for (int base = threadIdx.x; base < n_wu; base += kThreads * kSteps) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int u = base + j * kThreads;
      int uq, w;
      const int row = a.div_units.divmod(u, uq);  // row = plane * m + w
      const int pl = a.div_m.divmod(row, w);
      const int qq = uq * VQ;
      if (u >= n_wu || qq >= qv) continue;
      float best[VQ], xv[VQ];
      int tap[VQ];
      load_vec<T, VQ>(os + row * wq + qq, best);
#pragma unroll
      for (int l = 0; l < VQ; ++l) tap[l] = -1;
      const int start = w * s - lo;
      const T* col = xs + (pl * n + start) * wq + qq;
      if constexpr (K > 0) {
#pragma unroll
        for (int t = K - 1; t >= 0; --t) {  // the last hit is the first tap
          if (start + t >= 0 && start + t < n) {
            load_vec<T, VQ>(col + t * wq, xv);
#pragma unroll
            for (int l = 0; l < VQ; ++l) tap[l] = xv[l] == best[l] ? t : tap[l];
          }
        }
      } else {
        for (int t = min(k, n - start) - 1; t >= max(0, -start); --t) {
          load_vec<T, VQ>(col + t * wq, xv);
#pragma unroll
          for (int l = 0; l < VQ; ++l) tap[l] = xv[l] == best[l] ? t : tap[l];
        }
      }
      store_taps<VQ>(taps + row * wq + qq, tap);
    }
  }
  __syncthreads();

  // Phase B: dx[i] = sum over the windows w covering i, in increasing tap
  // offset d = i + lo - s * w (so decreasing w), of g[w] where taps[w] == d.
  // dx goes over x's slot in shared memory (phase B reads no x).
  const int n_xu = tp * n * wu;
  for (int base = threadIdx.x; base < n_xu; base += kThreads * kSteps) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int u = base + j * kThreads;
      int uq, i;
      const int row = a.div_units.divmod(u, uq);  // row = plane * n + i
      const int pl = a.div_n.divmod(row, i);
      const int qq = uq * VQ;
      if (u >= n_xu || qq >= qv) continue;
      const int num = i + lo;
      int w, d;
      if constexpr (S > 0) {
        w = static_cast<unsigned>(num) / S;
        d = num - w * S;
      } else {
        w = a.div_s.divmod(num, d);
      }
      if (w >= m) {
        d += (w - (m - 1)) * s;
        w = m - 1;
      }
      int c = (pl * m + w) * wq + qq;
      float acc[VQ], gv[VQ];
      int tv[VQ];
#pragma unroll
      for (int l = 0; l < VQ; ++l) acc[l] = 0.f;
      const auto add = [&]() {
        load_taps<VQ>(taps + c, tv);
        load_vec<T, VQ>(gs + c, gv);
#pragma unroll
        for (int l = 0; l < VQ; ++l) {
          if (tv[l] == d) acc[l] += gv[l];
        }
      };
      if constexpr (K > 0) {
#pragma unroll
        for (int t = 0; t < (K + S - 1) / S; ++t, --w, d += S, c -= wq) {
          if (w >= 0 && d < K) add();
        }
      } else {
        for (; w >= 0 && d < k; --w, d += s, c -= wq) add();
      }
      store_vec<T, VQ>(xs + row * wq + qq, acc);
    }
  }
  __syncthreads();
  if constexpr (TR) {
    copy_transposed<false>(xs, a.dx + xoff, pt, a.pt, n, wq, a.vec, a.div_pt);
  } else {
    copy_tile<false>(xs, a.dx + xoff, pt * n, qv, a.q, wq, whole, a.vec, a.div_qtv,
                     a.div_qt);
  }
}

template <typename T, int K, int S, int VQ, bool TR = false>
int launch_one(const PoolArgs<T>& a, long long blocks, int bytes, cudaStream_t stream) {
  const auto kernel = pool1d_bwd_kernel<T, K, S, VQ, TR>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The widest VQ (up to 16 bytes) that divides q and qt.
template <typename T, int K, int S>
int launch_vq(PoolArgs<T>& a, long long blocks, int bytes, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (a.q == 1 && a.pt % V == 0) {  // transposed: the same shared memory
    a.div_units = FastDiv(a.pt / V);
    return launch_one<T, K, S, V, true>(a, blocks, bytes, stream);
  }
  const auto fits = [&](int vq) { return vq * sizeof(T) <= 16 && a.q % vq == 0 && a.qt % vq == 0; };
  const int vq = fits(8) ? 8 : (fits(4) ? 4 : (fits(2) ? 2 : 1));
  a.div_units = FastDiv(a.qt / vq);
  switch (vq) {
    case 8:
      return launch_one<T, K, S, (sizeof(T) == 2 ? 8 : 4)>(a, blocks, bytes, stream);
    case 4:
      return launch_one<T, K, S, 4>(a, blocks, bytes, stream);
    case 2:
      return launch_one<T, K, S, 2>(a, blocks, bytes, stream);
    default:
      return launch_one<T, K, S, 1>(a, blocks, bytes, stream);
  }
}

template <typename T>
int launch(const void* x, const void* out, const void* g, void* dx, long long p, int n,
           int m, int q, int k, int s, int lo, int pt, int qt, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  PoolArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.out = static_cast<const T*>(out);
  a.g = static_cast<const T*>(g);
  a.dx = static_cast<T*>(dx);
  a.p = p;
  a.n = n;
  a.m = m;
  a.q = q;
  a.k = k;
  a.s = s;
  a.lo = lo;
  a.pt = pt;
  a.qt = qt;
  a.vec = vec;
  const int qtiles = (q + qt - 1) / qt;
  const long long blocks = (p + pt - 1) / pt * qtiles;
  const long long n_in = static_cast<long long>(pt) * n * qt;
  const long long n_win = static_cast<long long>(pt) * m * qt;
  if (blocks > 0x7fffffffLL || k > 127 || n_in > (1 << 24) || n_win > (1 << 24) ||
      (vec && qt != q && (qt % V != 0 || q % V != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.div_qtiles = FastDiv(qtiles);
  a.div_qt = FastDiv(qt);
  a.div_qtv = FastDiv(vec && qt != q ? qt / V : 1);
  a.div_n = FastDiv(n);
  a.div_m = FastDiv(m);
  a.div_s = FastDiv(s);
  a.div_pt = FastDiv(pt);
  const int bytes = round16(static_cast<int>(n_in * sizeof(T))) +
                    2 * round16(static_cast<int>(n_win * sizeof(T))) +
                    static_cast<int>(n_win);
  if (k == 3 && s == 2) return launch_vq<T, 3, 2>(a, blocks, bytes, stream);
  if (k == 3 && s == 1) return launch_vq<T, 3, 1>(a, blocks, bytes, stream);
  if (k == 2 && s == 2) return launch_vq<T, 2, 2>(a, blocks, bytes, stream);
  a.div_units = FastDiv(qt);
  return launch_one<T, 0, 0, 1>(a, blocks, bytes, stream);
}

}  // namespace

// pt, qt and vec come from the wrapper's plan (kernels/pool.py::plan).
extern "C" int coclr_pool1d_bwd(const void* x, const void* out, const void* g, void* dx,
                                long long p, int n, int m, int q, int k, int s, int lo,
                                int pt, int qt, int vec, int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, out, g, dx, p, n, m, q, k, s, lo, pt, qt, vec, st);
  }
  return launch<float>(x, out, g, dx, p, n, m, q, k, s, lo, pt, qt, vec, st);
}

extern "C" const char* coclr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
