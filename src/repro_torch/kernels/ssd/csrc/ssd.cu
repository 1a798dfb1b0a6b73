// Mamba2 SSD chunked scan for Hopper (sm_90a), from a zero state.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd/kernel.py::ssd_pallas
// (body _ssd_kernel).  For each chunk of Q = 64 positions it computes what
// the TPU kernel computes:
//
//   cum   = cumsum(dt * A)
//   y     = ((C B^T) o L o dt_j) x,  L[i,j] = exp(cum_i - cum_j) for i >= j, else 0
//   y    += (C o exp(cum)) state
//   state = exp(cum_last) state + (B o exp(cum_last - cum) dt)^T x
//
// x (B,S,H,P), B/C (B,S,G,N) in fp32 or bf16 (one dtype), dt (B,S,H) and
// A (H,) fp32; y (B,S,H,P) in x's dtype, final state (B,H,N,P) fp32.  Head h
// reads group h*G/H, straight from the grouped B/C (no expanded copy).
//
// Bound on the card: operations.  Per (b, h) the inter-chunk product and the
// state update are 2*S*N*P FMAs each, against one read of x and one write
// of y: at the serving shape (x 4x2048x80x64 fp32, N 128) that is ~24 GFLOP
// for ~357 MB, 0.36 ms at 67 TFLOP/s fp32 against 0.11 ms at 3.35 TB/s.
//
// Design (simple first; tensor cores come later):
// - one thread block per (b, h); the TPU's sequential chunk axis is a loop
//   inside the block, and the (N, P) fp32 state stays in shared memory;
// - per chunk, x (Q x P), dt and the head's B/C group (transposed to N x Q)
//   are staged in shared memory as fp32; one thread takes the prefix sum of
//   dt*A; every product is a 4x4 register tile of fp32 FMAs fed by float4
//   shared-memory loads;
// - a ragged last chunk is masked, not halved: padded positions get
//   dt = 0 and x = B = C = 0, so their decay is exp(0) = 1 and their update
//   0 (the final state stays exact), and their rows of y are not written;
// - L's entries are selected (i >= j ? exp(..) : 0), never multiplied by a
//   mask: for i < j the exponent is positive and may overflow to inf.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kQ = 64;           // chunk length
constexpr int kQS = kQ + 4;      // row stride of the N x Q and Q x Q tiles (16-byte rows)
constexpr int kT = kQ / 4;       // 4-row tiles per chunk
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[r][c] += a[r] * b[c]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

size_t smem_bytes(int N, int P) {
  return sizeof(float) * (static_cast<size_t>(N) * P + kQ * P + 2 * N * kQS + kQ * kQS + 4 * kQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
    float* __restrict__ final_state, int S, int H, int G, int N, int P) {
  extern __shared__ __align__(16) float smem[];
  float* state = smem;                   // N x P
  float* xs = state + N * P;             // Q x P
  float* bs = xs + kQ * P;               // N x kQS: bs[n*kQS + j] = B[j][n]
  float* cs = bs + N * kQS;              // N x kQS: cs[n*kQS + i] = C[i][n]
  float* mt = cs + N * kQS;              // Q x kQS: mt[j*kQS + i] = M[i][j]
  float* dts = mt + kQ * kQS;            // Q
  float* cum = dts + kQ;                 // Q
  float* ecum = cum + kQ;                // Q: exp(cum_i)
  float* wj = ecum + kQ;                 // Q: exp(total - cum_j) * dt_j

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;             // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h * G / H;
  const float a = A[h];
  const int pt = P / 4;

  for (int i = tid; i < N * P; i += kThreads) state[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kQ) {
    const int valid = min(kQ, S - s0);
    const long long row0 = static_cast<long long>(b) * S + s0;   // (b, s0) row

    // ---- stage the chunk (zeros past S) ------------------------------------
    for (int idx = tid; idx < kQ * P; idx += kThreads) {
      const int q = idx / P;
      const int p = idx - q * P;
      xs[idx] = q < valid ? to_f(x[((row0 + q) * H + h) * P + p]) : 0.f;
    }
    for (int idx = tid; idx < kQ * N; idx += kThreads) {
      const int q = idx / N;
      const int n = idx - q * N;
      float vb = 0.f, vc = 0.f;
      if (q < valid) {
        const long long off = ((row0 + q) * G + g) * N + n;
        vb = to_f(Bm[off]);
        vc = to_f(Cm[off]);
      }
      bs[n * kQS + q] = vb;
      cs[n * kQS + q] = vc;
    }
    if (tid < kQ) dts[tid] = tid < valid ? dt[(row0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int q = 0; q < kQ; ++q) {
        acc = __fadd_rn(acc, __fmul_rn(dts[q], a));
        cum[q] = acc;
      }
    }
    __syncthreads();
    const float total = cum[kQ - 1];
    if (tid < kQ) {
      ecum[tid] = expf(cum[tid]);
      wj[tid] = expf(total - cum[tid]) * dts[tid];
    }

    // ---- M = (C B^T) o L o dt_j, lower-triangular 4x4 tiles ----------------
    for (int t = tid; t < kT * kT; t += kThreads) {
      const int ti = t / kT;
      const int tj = t - ti * kT;
      if (tj > ti) continue;               // never read
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) outer4(acc, ld4(&cs[n * kQS + ti * 4]), ld4(&bs[n * kQS + tj * 4]));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tj * 4 + c;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ti * 4 + r;
          mt[j * kQS + i] = i >= j ? acc[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = M x + exp(cum) o (C state), 4x4 tiles of (Q, P) ---------------
    for (int t = tid; t < kT * pt; t += kThreads) {
      const int ti = t / pt;
      const int tp = t - ti * pt;
      float intra[4][4] = {};
      const int jmax = min(ti * 4 + 4, valid);
      for (int j = 0; j < jmax; ++j) outer4(intra, ld4(&mt[j * kQS + ti * 4]), ld4(&xs[j * P + tp * 4]));
      float inter[4][4] = {};
      for (int n = 0; n < N; ++n) outer4(inter, ld4(&cs[n * kQS + ti * 4]), ld4(&state[n * P + tp * 4]));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti * 4 + r;
        if (i >= valid) continue;
        T* yr = y + ((row0 + i) * H + h) * P + tp * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c) yr[c] = from_f<T>(intra[r][c] + ecum[i] * inter[r][c]);
      }
    }
    __syncthreads();                       // every read of the old state is done

    // ---- state = exp(total) state + (B o w)^T x, 4x4 tiles of (N, P) -------
    const float decay = expf(total);
    for (int t = tid; t < (N / 4) * pt; t += kThreads) {
      const int tn = t / pt;
      const int tp = t - tn * pt;
      float acc[4][4] = {};
      for (int j = 0; j < valid; ++j) {
        const float w = wj[j];
        const float4 bw = make_float4(bs[(tn * 4 + 0) * kQS + j] * w, bs[(tn * 4 + 1) * kQS + j] * w,
                                      bs[(tn * 4 + 2) * kQS + j] * w, bs[(tn * 4 + 3) * kQS + j] * w);
        outer4(acc, bw, ld4(&xs[j * P + tp * 4]));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* sr = &state[(tn * 4 + r) * P + tp * 4];
#pragma unroll
        for (int c = 0; c < 4; ++c) sr[c] = decay * sr[c] + acc[r][c];
      }
    }
    __syncthreads();                       // before the next chunk overwrites the tiles
  }

  float* fs = final_state + static_cast<long long>(bh) * N * P;
  for (int i = tid; i < N * P; i += kThreads) fs[i] = state[i];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   void* y, void* final_state, int batch, int S, int H, int G, int N, int P,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(N, P);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<batch * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(final_state), S, H, G, N, P);
  return cudaGetLastError();
}

}  // namespace

// dtype codes (x, B, C, y): 0 float32, 1 bfloat16.  dt and A are float32.
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, void* y, void* final_state, int batch, int S, int H,
                             int G, int N, int P, int dtype, void* stream) {
  // clear any error left by an earlier launch so the return value is ours
  cudaGetLastError();
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0 ||
      N % 4 != 0 || P % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(x, dt, A, B, C, y, final_state, batch, S, H, G, N, P, s); break;
    case 1: err = launch<__nv_bfloat16>(x, dt, A, B, C, y, final_state, batch, S, H, G, N, P, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
