// Fused ColorJitter + RandomGray + Normalize over uint8 video frames.
//
// Replaces the TPU kernel coclr_tpu/ops/pallas_aug.py::fused_jitter_normalize
// (kernel body _jitter_kernel, hue math _hue_rotate). Same contract:
//   x    [F, 3, S1, S2] uint8, each frame one contiguous run of 3 * S1 * S2
//        bytes, channel-planar (channel stride S1 * S2, pixel stride 1) or
//        channels-last (channel stride 1, pixel stride 3); any frame stride
//   fb, fc, fs, fh [F] float32 per-frame jitter factors (1, 1, 1, 0 = identity)
//   gray [F] int32: -1 keeps colour, else the channel copied to all three
//   ord  [F] int32: four 2-bit op codes, position 0 in the low bits
//        (0 brightness, 1 contrast, 2 saturation, 3 hue)
//   out  [F, 3, S1, S2] bfloat16 or float32, contiguous,
//        = normalize(gray(jitter(x / 255)))
// All arithmetic is float32, as in the Pallas kernel. The contrast op blends
// toward the luma mean of the WHOLE current frame at its position in the
// chain.
//
// What bounds it on an H100: by the published rates, bytes (each frame is
// read as uint8 and written as bfloat16, 3 bytes per pixel in and 6 out).
// In practice its instructions: the chain is a few hundred float32
// instructions per pixel, compiled without fused multiply-adds.
//
// The first design read each frame from device memory twice (pass 1 for the
// contrast mean, pass 2 for the chain), in 4-byte loads, wrote 8-byte stores,
// reduced hue angles with fmodf (a long library routine), and needed planar
// input, for which its caller copied every clip once more.
//
// This design: one block per frame. The frame is staged into dynamic shared
// memory with 16-byte cp.async copies (49,152 B at 128 x 128), so pass 1 (the
// chain up to the contrast op and a block-wide luma sum, only where
// fc != 1) and pass 2 (the whole chain) both read shared memory and each
// frame is read from device memory once, in either input layout. A thread
// takes 8 consecutive pixels: the op switch runs once per 8 pixels, and each
// channel's 8 outputs leave as one 16-byte store (bfloat16). mod1(a) is
// a - floorf(a), which is torch.remainder(a, 1.0) bit for bit. Divisions
// (hue and normalize) are a reciprocal and a multiply, within 2 ulp of the
// IEEE quotient; chip_smoke holds the output to 1 bf16 ULP of the plain
// version on all but 1e-3 of the values. Frames too
// large for shared memory (3 * S1 * S2 above the card's 227 KB) take the
// same two passes reading device memory instead. Pixel counts that are not a
// multiple of 8 go one pixel per thread with scalar stores. Built with
// -fmad=false so the float32 arithmetic rounds as the plain PyTorch
// version's does.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

// a / b as a reciprocal and a multiply (at most 2 ulp from IEEE division):
// the IEEE divisions took half the kernel's time. b == 1 stays exact.
__device__ __forceinline__ float fdiv(float a, float b) { return __fdividef(a, b); }

struct JitterArgs {
  const uint8_t* x;
  void* out;
  const float* fb;
  const float* fc;
  const float* fs;
  const float* fh;
  const int* gray;
  const int* orders;
  long long frame_stride;  // bytes between frames of x
  int hw;
  int channels_last;  // 0: planar frames, 1: pixel-interleaved frames
  int aligned16;      // every frame of x starts 16-byte aligned
  float mean[3], std[3];
};

__device__ __forceinline__ float clip01(float a) { return fminf(fmaxf(a, 0.f), 1.f); }

// Python-style a % 1.0 (torch.remainder, jnp.remainder): exact, since the
// fractional part of a float32 is representable.
__device__ __forceinline__ float mod1(float a) { return a - floorf(a); }

__device__ __forceinline__ float luma(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}

// HSV hue rotation by fh turns; the where-chains and tie order of
// pallas_aug._hue_rotate (r wins ties over g, g over b).
__device__ __forceinline__ void hue_rotate(float& r, float& g, float& b, float fh) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = maxc - minc;
  const float s = maxc > 0.f ? fdiv(delta, fmaxf(maxc, 1e-12f)) : 0.f;
  const float safe = fmaxf(delta, 1e-12f);
  const float rc = fdiv(maxc - r, safe);
  const float gc = fdiv(maxc - g, safe);
  const float bc = fdiv(maxc - b, safe);
  float h = (r == maxc) ? bc - gc : ((g == maxc) ? 2.f + rc - bc : 4.f + gc - rc);
  h = mod1(fdiv(h, 6.f));
  if (delta == 0.f) h = 0.f;
  h = mod1(h + fh);
  const float v = maxc;
  const float i = floorf(h * 6.f);
  const float f = h * 6.f - i;
  const float p = v * (1.f - s);
  const float q = v * (1.f - s * f);
  const float t = v * (1.f - s * (1.f - f));
  const int sector = static_cast<int>(i) % 6;
  const float r2 = (sector == 0 || sector == 5) ? v : (sector == 1 ? q : (sector == 4 ? t : p));
  const float g2 = sector == 0 ? t : ((sector == 1 || sector == 2) ? v : (sector == 3 ? q : p));
  const float b2 = sector <= 1 ? p : (sector == 2 ? t : (sector == 5 ? q : v));
  r = clip01(r2);
  g = clip01(g2);
  b = clip01(b2);
}

struct FrameParams {
  float fb, fc, fs, fh;
  int order;
  float cm[4];  // luma mean * (1 - fc) at each contrast position, once known

  __device__ __forceinline__ int code(int pos) const { return (order >> (2 * pos)) & 3; }
  // cm[pos] by selects and branches: a dynamic index would put cm in local
  // memory
  __device__ __forceinline__ float cmean(int pos) const {
    return pos == 0 ? cm[0] : (pos == 1 ? cm[1] : (pos == 2 ? cm[2] : cm[3]));
  }
  __device__ __forceinline__ void set_cmean(int pos, float v) {
    if (pos == 0) {
      cm[0] = v;
    } else if (pos == 1) {
      cm[1] = v;
    } else if (pos == 2) {
      cm[2] = v;
    } else {
      cm[3] = v;
    }
  }
};

// Runs positions [0, npos) of the frame's op chain on V pixels.
template <int V>
__device__ __forceinline__ void chain(const FrameParams& fp, int npos, float* r, float* g,
                                      float* b) {
  for (int pos = 0; pos < npos; ++pos) {
    switch (fp.code(pos)) {
      case 0:
#pragma unroll
        for (int j = 0; j < V; ++j) {
          r[j] = clip01(r[j] * fp.fb);
          g[j] = clip01(g[j] * fp.fb);
          b[j] = clip01(b[j] * fp.fb);
        }
        break;
      case 1: {
        const float m = fp.cmean(pos);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          r[j] = clip01(r[j] * fp.fc + m);
          g[j] = clip01(g[j] * fp.fc + m);
          b[j] = clip01(b[j] * fp.fc + m);
        }
        break;
      }
      case 2:
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float l = luma(r[j], g[j], b[j]) * (1.f - fp.fs);
          r[j] = clip01(r[j] * fp.fs + l);
          g[j] = clip01(g[j] * fp.fs + l);
          b[j] = clip01(b[j] * fp.fs + l);
        }
        break;
      default:
        if (fp.fh != 0.f) {  // exact identity at fh == 0
#pragma unroll
          for (int j = 0; j < V; ++j) hue_rotate(r[j], g[j], b[j], fp.fh);
        }
        break;
    }
  }
}

__device__ __forceinline__ void unpack8(uint2 w, uint8_t* u) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = static_cast<uint8_t>(w.x >> (8 * j));
    u[4 + j] = static_cast<uint8_t>(w.y >> (8 * j));
  }
}

// Pixels [px, px + V) of one frame as float32 in [0, 1]. `src` is the frame
// in shared memory (kStaged: aligned, 8-byte loads when V == 8) or in
// device memory (byte loads).
template <int V, bool kStaged>
__device__ __forceinline__ void fetch(const uint8_t* src, int px, int hw, bool channels_last,
                                      float* r, float* g, float* b) {
  uint8_t u[3][V];
  if (kStaged && V == 8) {
    if (channels_last) {
      const uint2* w = reinterpret_cast<const uint2*>(src + 3 * px);
      uint8_t t[24];
      unpack8(w[0], t);
      unpack8(w[1], t + 8);
      unpack8(w[2], t + 16);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        u[0][j] = t[3 * j];
        u[1][j] = t[3 * j + 1];
        u[2][j] = t[3 * j + 2];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        unpack8(*reinterpret_cast<const uint2*>(src + c * hw + px), u[c]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        u[c][j] = channels_last ? src[3 * (px + j) + c] : src[c * hw + px + j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    r[j] = static_cast<float>(u[0][j]) * (1.f / 255.f);
    g[j] = static_cast<float>(u[1][j]) * (1.f / 255.f);
    b[j] = static_cast<float>(u[2][j]) * (1.f / 255.f);
  }
}

template <typename OutT, int V>
__device__ __forceinline__ void store(OutT* dst, const float* v) {
  if constexpr (V == 8 && sizeof(OutT) == 2) {
    uint4 packed;
    uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      words[j] = *reinterpret_cast<uint32_t*>(&two);
    }
    *reinterpret_cast<uint4*>(dst) = packed;
  } else if constexpr (V == 8) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = coclr::from_f32<OutT>(v[j]);
  }
}

__device__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? scratch[threadIdx.x] : 0.f;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  v = scratch[0];
  __syncthreads();  // scratch is reused by the next reduction
  return v;
}

// Copies one frame (n bytes) into shared memory: 16-byte cp.async copies
// when the frame starts 16-byte aligned, bytes otherwise.
__device__ __forceinline__ void stage_frame(uint8_t* smem, const uint8_t* src, int n,
                                            bool aligned16) {
  int body = 0;
  if (aligned16) {
    body = n / 16 * 16;
    for (int c = threadIdx.x; c < n / 16; c += kThreads) {
      coclr::cp_async16(smem + 16 * c, src + 16 * c);
    }
  }
  for (int e = body + threadIdx.x; e < n; e += kThreads) smem[e] = src[e];
  coclr::cp_async_wait_all();
  __syncthreads();
}

template <typename OutT, int V, bool kStaged>
__global__ void __launch_bounds__(kThreads) jitter_kernel(const JitterArgs a) {
  extern __shared__ __align__(16) uint8_t frame_smem[];
  __shared__ float scratch[32];
  const int frame = blockIdx.x;
  const int hw = a.hw;
  const bool cl = a.channels_last != 0;
  const uint8_t* xf = a.x + static_cast<long long>(frame) * a.frame_stride;
  if constexpr (kStaged) stage_frame(frame_smem, xf, 3 * hw, a.aligned16 != 0);
  const uint8_t* src = kStaged ? frame_smem : xf;
  OutT* of = static_cast<OutT*>(a.out) + static_cast<long long>(frame) * 3 * hw;

  FrameParams fp;
  fp.fb = a.fb[frame];
  fp.fc = a.fc[frame];
  fp.fs = a.fs[frame];
  fp.fh = a.fh[frame];
  fp.order = a.orders[frame];
  fp.cm[0] = fp.cm[1] = fp.cm[2] = fp.cm[3] = 0.f;
  const int sel = a.gray[frame];
  const int items = hw / V;

  // pass 1: the whole-frame luma mean at each contrast position (a blend
  // with fc == 1 is the identity whatever the mean)
  for (int pos = 0; pos < 4; ++pos) {
    if (fp.code(pos) != 1 || fp.fc == 1.f) continue;
    float acc = 0.f;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      float r[V], g[V], b[V];
      fetch<V, kStaged>(src, it * V, hw, cl, r, g, b);
      chain<V>(fp, pos, r, g, b);
#pragma unroll
      for (int j = 0; j < V; ++j) acc += luma(r[j], g[j], b[j]);
    }
    fp.set_cmean(pos, block_sum(acc, scratch) / static_cast<float>(hw) * (1.f - fp.fc));
  }

  // pass 2: the full chain, RandomGray, normalize, store
  for (int it = threadIdx.x; it < items; it += kThreads) {
    float r[V], g[V], b[V];
    fetch<V, kStaged>(src, it * V, hw, cl, r, g, b);
    chain<V>(fp, 4, r, g, b);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (sel >= 0) {
        const float v = sel == 0 ? r[j] : (sel == 1 ? g[j] : b[j]);
        r[j] = g[j] = b[j] = v;
      }
      r[j] = fdiv(r[j] - a.mean[0], a.std[0]);
      g[j] = fdiv(g[j] - a.mean[1], a.std[1]);
      b[j] = fdiv(b[j] - a.mean[2], a.std[2]);
    }
    store<OutT, V>(of + it * V, r);
    store<OutT, V>(of + hw + it * V, g);
    store<OutT, V>(of + 2 * hw + it * V, b);
  }
}

template <typename OutT, int V, bool kStaged>
int launch_one(const JitterArgs& a, int frames, cudaStream_t stream) {
  const int bytes = kStaged ? 3 * a.hw : 0;
  if (kStaged) {  // above 48 KB with the static scratch needs the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        jitter_kernel<OutT, V, kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  jitter_kernel<OutT, V, kStaged><<<frames, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch(const JitterArgs& a, int frames, cudaStream_t stream) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // the static scratch of block_sum shares the block's shared memory
  const bool staged = 3LL * a.hw + 32 * sizeof(float) <= optin;
  if (a.hw % 8 == 0) {
    return staged ? launch_one<OutT, 8, true>(a, frames, stream)
                  : launch_one<OutT, 8, false>(a, frames, stream);
  }
  return staged ? launch_one<OutT, 1, true>(a, frames, stream)
                : launch_one<OutT, 1, false>(a, frames, stream);
}

}  // namespace

extern "C" int coclr_jitter_normalize(const void* x, void* out, const void* fb, const void* fc,
                                      const void* fs, const void* fh, const void* gray,
                                      const void* orders, int frames, int hw,
                                      long long frame_stride, int channels_last, int out_bf16,
                                      float m0, float m1, float m2, float s0, float s1,
                                      float s2, void* stream) {
  JitterArgs a;
  a.x = static_cast<const uint8_t*>(x);
  a.out = out;
  a.fb = static_cast<const float*>(fb);
  a.fc = static_cast<const float*>(fc);
  a.fs = static_cast<const float*>(fs);
  a.fh = static_cast<const float*>(fh);
  a.gray = static_cast<const int*>(gray);
  a.orders = static_cast<const int*>(orders);
  a.frame_stride = frame_stride;
  a.hw = hw;
  a.channels_last = channels_last;
  a.aligned16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 && frame_stride % 16 == 0;
  a.mean[0] = m0;
  a.mean[1] = m1;
  a.mean[2] = m2;
  a.std[0] = s0;
  a.std[1] = s1;
  a.std[2] = s2;
  auto st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(a, frames, st) : launch<float>(a, frames, st);
}

extern "C" const char* coclr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
