// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention_fwd (body
// _flash_fwd_kernel).  Same function: softmax(q k^T * hd^-1/2 + mask) v with
// q/k/v upcast to fp32, an fp32 online-softmax state (acc, m, l) carried
// across key tiles, a causal mask from row/column indices or from explicit
// q_pos/k_pos (k_pos <= q_pos), the finite NEG_INF = -0.7 * f32max for masked
// scores (a fully masked row yields the mean of v), l clamped at 1e-30, and
// optional (m, l) residuals.
//
// Layout: q (B, Sq, H, HD), k/v (B, Sk, H, HD) contiguous with equal head
// counts, out like q; positions (Sq,)/(Sk,) or (B, S) int32; m/l (B, H, Sq).
//
// Design.  The TPU kernel's sequential kv grid dimension becomes a loop
// inside the block.  One block (4 warps) per (batch*head, tile of q rows);
// key/value tiles of 128 rows are staged in shared memory in the input
// dtype (K with a padded pitch so the per-lane key reads hit distinct
// banks).  Each lane scores whole keys against its warp's rows with fp32
// FMAs (no tensor cores, so fp32 inputs stay true fp32), the warp reduces
// the tile's max and sum with shuffles, and each lane accumulates its
// head_dim/32 output columns.  Two shapes of block:
//   * prefill (Sq > 4): every warp owns 4 q rows and all keys of a tile
//     (16 rows per block, the K/V tile reused by 16 rows);
//   * decode (Sq <= 4): one q row per block, the 4 warps split each key tile
//     and merge their (m, l, acc) through shared memory at the end.
// Keys beyond Sk score -inf (and read zeros), so they contribute exactly 0;
// no block-size halving is needed for ragged Sq/Sk.
//
// Bound on the card: bytes, on paper, at both serving shapes — at decode
// (Sq = 1) the expanded K/V is read once for ~4 flops per byte, and a
// 256-row prefill chunk is still below the bf16 ridge.  This first kernel
// does its products with fp32 CUDA-core FMAs (far below the tensor-core
// rate the bound assumes) and no cp.async/TMA pipelining; wgmma, TMA,
// reading compact GQA heads and skipping fully masked key tiles are later
// work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 128;
// the JAX package's NEG_INF: the double -0.7 * f32max rounded to float
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);

constexpr size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// two consecutive head_dim elements of a shared-memory K row, as floats
__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* qpos;            // null: row index
  const int* kpos;            // null: key index
  long long qpos_bstride;     // 0 for (S,) positions
  long long kpos_bstride;
  float* m_out;               // null: no residuals
  float* l_out;
  int B, H, Sq, Sk;
  int causal;
  float scale;
};

template <typename T, int HD, int RPW, int KS>
struct Smem {
  static constexpr int kRows = (kWarps / KS) * RPW;
  static constexpr int kKeysPerWarp = kTileK / KS;
  static constexpr int kPitch = HD + (sizeof(T) == 4 ? 1 : 2);
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = align16(k_off + sizeof(T) * kTileK * kPitch);
  static constexpr size_t q_off = align16(v_off + sizeof(T) * kTileK * HD);
  static constexpr size_t p_off = align16(q_off + sizeof(float) * kRows * HD);
  static constexpr size_t kp_off = align16(p_off + sizeof(float) * kWarps * RPW * kKeysPerWarp);
  static constexpr size_t m_off = align16(kp_off + sizeof(int) * kTileK);
  static constexpr size_t total =
      align16(m_off + (KS > 1 ? sizeof(float) * kWarps * RPW * (HD + 2) : 0));
};

// RPW: q rows per warp; KS: warps that split one key tile (1 or 4).
template <typename T, int HD, int RPW, int KS>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  using L = Smem<T, HD, RPW, KS>;
  constexpr int kRows = L::kRows;
  constexpr int kKeysPerWarp = L::kKeysPerWarp;
  constexpr int kKPL = kKeysPerWarp / 32;            // keys per lane per tile
  constexpr int kPitch = L::kPitch;
  constexpr int kDPL = HD / 32;                      // output columns per lane
  constexpr int kVec = 16 / sizeof(T);               // elements per 16-byte load
  constexpr int kChunks = HD / kVec;

  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* Ps = reinterpret_cast<float*>(smem + L::p_off);
  int* KPs = reinterpret_cast<int*>(smem + L::kp_off);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rg = warp / KS;                          // row group of this warp
  const int ks = warp % KS;                          // key split of this warp
  const long long seq_stride = static_cast<long long>(p.H) * HD;
  const T* qb = static_cast<const T*>(p.q) + (static_cast<long long>(b) * p.Sq * p.H + h) * HD;
  const T* kb = static_cast<const T*>(p.k) + (static_cast<long long>(b) * p.Sk * p.H + h) * HD;
  const T* vb = static_cast<const T*>(p.v) + (static_cast<long long>(b) * p.Sk * p.H + h) * HD;

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int qi = q0 + i / HD;
    Qs[i] = qi < p.Sq ? to_f(qb[qi * seq_stride + i % HD]) : 0.f;
  }
  int qp[RPW];
  float m[RPW], l[RPW], acc[RPW][kDPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + rg * RPW + r;
    qp[r] = qi < p.Sq ? (p.qpos ? p.qpos[b * p.qpos_bstride + qi] : qi) : 0;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) acc[r][dd] = 0.f;
  }

  const float* Qw = Qs + rg * RPW * HD;
  float* Pw = Ps + warp * RPW * kKeysPerWarp;
  const int key0 = ks * kKeysPerWarp;                // this warp's first key in a tile

  for (int kt = 0; kt < p.Sk; kt += kTileK) {
    __syncthreads();                                 // previous tile fully consumed
    for (int i = tid; i < kTileK * kChunks; i += kThreads) {
      const int jj = i / kChunks;
      const int c = i % kChunks;
      const int j = kt + jj;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (j < p.Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + j * seq_stride + c * kVec);
        vv = *reinterpret_cast<const uint4*>(vb + j * seq_stride + c * kVec);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(Ks + jj * kPitch + c * kVec);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<uint4*>(Vs + jj * HD + c * kVec) = vv;
    }
    if (tid < kTileK) {
      const int j = kt + tid;
      KPs[tid] = j < p.Sk ? (p.kpos ? p.kpos[b * p.kpos_bstride + j] : j) : 0;
    }
    __syncthreads();

    // scores of this lane's keys against the warp's rows
    float s[RPW][kKPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int i = 0; i < kKPL; ++i) s[r][i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; d += 2) {
      float2 qv[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) qv[r] = *reinterpret_cast<const float2*>(Qw + r * HD + d);
#pragma unroll
      for (int i = 0; i < kKPL; ++i) {
        const float2 kv2 = load2(Ks + (key0 + i * 32 + lane) * kPitch + d);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          s[r][i] = fmaf(qv[r].x, kv2.x, s[r][i]);
          s[r][i] = fmaf(qv[r].y, kv2.y, s[r][i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kKPL; ++i) {
      const int jj = key0 + i * 32 + lane;
      const bool in_range = kt + jj < p.Sk;
      const int kp = KPs[jj];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float x = s[r][i] * p.scale;
        if (!in_range) x = -__int_as_float(0x7f800000);  // -inf: absent key weighs exactly 0
        else if (p.causal && kp > qp[r]) x = kNegInf;
        s[r][i] = x;
      }
    }

    // online softmax over this tile
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int i = 1; i < kKPL; ++i) mx = fmaxf(mx, s[r][i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKPL; ++i) {
        const float e = expf(s[r][i] - m_new);
        Pw[r * kKeysPerWarp + i * 32 + lane] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) acc[r][dd] *= corr;
    }
    __syncwarp();

    const T* Vw = Vs + key0 * HD;
#pragma unroll 4
    for (int kk = 0; kk < kKeysPerWarp; ++kk) {
      float pr[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) pr[r] = Pw[r * kKeysPerWarp + kk];
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) {
        const float vd = to_f(Vw[kk * HD + lane + 32 * dd]);
#pragma unroll
        for (int r = 0; r < RPW; ++r) acc[r][dd] = fmaf(pr[r], vd, acc[r][dd]);
      }
    }
  }

  if (KS > 1) {
    // merge the key splits' partial (m, l, acc) of each row
    float* Ms = reinterpret_cast<float*>(smem + L::m_off);
    float* Mw = Ms + warp * RPW * (HD + 2);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (lane == 0) {
        Mw[r * (HD + 2)] = m[r];
        Mw[r * (HD + 2) + 1] = l[r];
      }
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) Mw[r * (HD + 2) + 2 + lane + 32 * dd] = acc[r][dd];
    }
    __syncthreads();
    if (ks != 0) return;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float M = kNegInf;
      for (int w = 0; w < KS; ++w) M = fmaxf(M, Ms[((rg * KS + w) * RPW + r) * (HD + 2)]);
      float Lsum = 0.f;
      float A[kDPL];
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) A[dd] = 0.f;
      for (int w = 0; w < KS; ++w) {
        const float* src = Ms + ((rg * KS + w) * RPW + r) * (HD + 2);
        const float c = expf(src[0] - M);
        Lsum += src[1] * c;
#pragma unroll
        for (int dd = 0; dd < kDPL; ++dd) A[dd] += src[2 + lane + 32 * dd] * c;
      }
      m[r] = M;
      l[r] = Lsum;
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) acc[r][dd] = A[dd];
    }
  }

  T* ob = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.Sq * p.H + h) * HD;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + rg * RPW + r;
    if (qi >= p.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) {
      ob[qi * seq_stride + lane + 32 * dd] = from_f<T>(acc[r][dd] / denom);
    }
    if (p.m_out != nullptr && lane == 0) {
      const long long idx = (static_cast<long long>(b) * p.H + h) * p.Sq + qi;
      p.m_out[idx] = m[r];
      p.l_out[idx] = l[r];
    }
  }
}

template <typename T, int HD, int RPW, int KS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Smem<T, HD, RPW, KS>;
  auto kernel = flash_fwd_kernel<T, HD, RPW, KS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::total));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Sq + L::kRows - 1) / L::kRows);
  kernel<<<grid, kThreads, L::total, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_shape(const Params& p, cudaStream_t stream) {
  if (p.Sq <= 4) return launch<T, HD, 1, 4>(p, stream);   // decode: split keys over warps
  return launch<T, HD, 4, 1>(p, stream);                  // prefill: 16 q rows per block
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_shape<T, 32>(p, stream);
    case 64: return dispatch_shape<T, 64>(p, stream);
    case 128: return dispatch_shape<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, const void* qpos, const void* kpos,
    long long qpos_bstride, long long kpos_bstride, void* m_out, void* l_out, int B, int H,
    int Sq, int Sk, int hd, int causal, float scale, int dtype, void* stream) {
  cudaGetLastError();                                // report only this launch's error
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || (qpos == nullptr) != (kpos == nullptr) ||
      (m_out == nullptr) != (l_out == nullptr) || Sq > 65535 * 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.qpos_bstride = qpos_bstride;
  p.kpos_bstride = kpos_bstride;
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch_hd<float>(p, hd, s));
    case 1: return static_cast<int>(dispatch_hd<__nv_bfloat16>(p, hd, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
