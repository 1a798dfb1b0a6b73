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
// Both templates keep one thread block per (b, h): the TPU's sequential
// chunk axis is a loop inside the block, and the (N, P) fp32 state stays in
// shared memory.  Both mask a ragged last chunk, never halve it: padded
// positions get dt = 0 and x = B = C = 0, so their decay is exp(0) = 1 and
// their update 0 (the final state stays exact), and their rows of y are not
// written.  Both select L's entries (i >= j ? exp(..) : 0), never multiply
// by a mask: for i < j the exponent is positive and may overflow to inf.
//
// fp32 (ssd_kernel<float>): x, B and C are fp32, so every product is fp32
// FMAs on CUDA cores (no TF32).  Per chunk, x (Q x P) and the head's B/C
// group (transposed to N x Q) are staged as fp32; one thread takes the
// prefix sum of dt*A; every product is a 4x4 register tile fed by float4
// shared-memory loads.  134 KB of shared memory at N 128, P 64: one block
// per SM.  Its bound at the serving shape (x 4x2048x80x64, N 128) is
// operations: ~24 GFLOP, 0.36 ms at 67 TFLOP/s, against ~357 MB.
//
// bf16 (ssd_kernel_bf16_tc): what bounds it at the serving shape is bytes:
// x read and y written once (~168 MB of ~185 MB) take 0.055 ms at 3.35 TB/s,
// against ~24 GFLOP, 0.025 ms at 989 TFLOP/s.  The design puts the four
// products on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32
// accumulate) so the arithmetic stops being the limit, and halves the
// shared memory so two blocks share an SM:
// - x (Q x P), B and C (Q x N) are staged in bf16 by cp.async, rows padded
//   by 16 bytes so ldmatrix hits 8 distinct bank groups; they enter the
//   tensor cores exactly;
// - an operand that is fp32 (M = C B^T o L o dt, the state, w o x) is split
//   into two bf16 terms, hi = bf16(v) and lo = bf16(v - hi), and costs two
//   mmas: the residual is <= 2^-18 |v|, so the products stay fp32-class;
// - C B^T runs once per 16 x 16 block (r, kk <= r) of the chunk's lower-
//   triangular M, the 10 blocks spread over the 8 warps and started while
//   warp 0 takes the prefix sum of dt*A (a warp scan); M = C B^T o L o dt
//   goes to shared memory as its hi and lo terms;
// - then each warp owns 8 columns of y over all 64 rows, so the work is
//   even and each state fragment is split once per warp: C (state split on
//   load) scaled by exp(cum_i), plus M (hi, lo) times x (ldmatrix.trans),
//   into one accumulator, rounded to bf16 once;
// - w o x then takes M's buffers (hi, lo), and every warp takes 16 x 16
//   tiles of the state update B^T (w o x), B^T read by ldmatrix.trans;
// - ~96 KB of shared memory at N 128, P 64: two blocks per SM, so the 320
//   blocks of the serving shape run in 2 waves on 132 SMs, not 3.
// What still bounds it is latency, not the tensor cores or the bytes: a
// block walks its 32 chunks in order through six barriers each, with 16
// warps on an SM (see PERF.md).
// Its shapes: N and P multiples of 16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kQ = 64;           // chunk length
constexpr int kQS = kQ + 4;      // row stride of the N x Q and Q x Q tiles (16-byte rows)
constexpr int kT = kQ / 4;       // 4-row tiles per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// Shared memory of the bf16 template, in bytes from the start: the fp32
// state (N rows of P + 4, a stride that spreads a fragment's column reads
// over 32 banks), then bf16 tiles with rows padded by 8 elements: x, B, C,
// and the hi and lo terms of M (Q x Q), later of w o x (Q x P); then dt,
// cum, exp(cum) and w.
struct Bf16Layout {
  int xp, np, mp, sp;                     // row pitches: x, B and C, M and w o x, state
  size_t xs, bs, cs, hi, lo, vec, total;
};

__host__ __device__ inline Bf16Layout bf16_layout(int N, int P) {
  Bf16Layout L;
  L.xp = P + 8;
  L.np = N + 8;
  L.mp = (P > kQ ? P : kQ) + 8;
  L.sp = P + 4;
  L.xs = sizeof(float) * static_cast<size_t>(N) * L.sp;
  L.bs = L.xs + sizeof(__nv_bfloat16) * kQ * L.xp;
  L.cs = L.bs + sizeof(__nv_bfloat16) * kQ * L.np;
  L.hi = L.cs + sizeof(__nv_bfloat16) * kQ * L.np;
  L.lo = L.hi + sizeof(__nv_bfloat16) * kQ * L.mp;
  L.vec = L.lo + sizeof(__nv_bfloat16) * kQ * L.mp;
  L.total = L.vec + sizeof(float) * 4 * kQ;
  return L;
}

size_t smem_bytes(int N, int P, bool bf16) {
  if (bf16) return bf16_layout(N, P).total;
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

// v (two fp32 values) = hi + lo + O(2^-18 |v|), each term a bf16 pair
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// The 10 blocks (r, kk), kk <= r, of the chunk's 64 x 64 lower-triangular M
// in 16 x 16 tiles; warp w takes block w, and warps 6 and 7 also 8 and 9.
__device__ __forceinline__ void m_block(int it, int& r, int& kk) {
  r = it < 1 ? 0 : it < 3 ? 1 : it < 6 ? 2 : 3;
  kk = it - r * (r + 1) / 2;
}

__global__ void __launch_bounds__(kThreads, 2) ssd_kernel_bf16_tc(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y,
    float* __restrict__ final_state, int S, int H, int G, int N, int P) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) float smem[];          // one symbol with the fp32 template
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const Bf16Layout L = bf16_layout(N, P);
  float* state = smem;                                             // N x sp
  bf16* xs = reinterpret_cast<bf16*>(base + L.xs);                 // Q x xp
  bf16* bs = reinterpret_cast<bf16*>(base + L.bs);                 // Q x np
  bf16* cs = reinterpret_cast<bf16*>(base + L.cs);                 // Q x np
  bf16* hi = reinterpret_cast<bf16*>(base + L.hi);                 // Q x mp: M, then w o x
  bf16* lo = reinterpret_cast<bf16*>(base + L.lo);                 // Q x mp
  float* dts = reinterpret_cast<float*>(base + L.vec);             // Q
  float* cum = dts + kQ;                                           // Q
  float* ecum = cum + kQ;                                          // Q: exp(cum_i)
  float* wj = ecum + kQ;                                           // Q: exp(total - cum_j) * dt_j

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / 4;                // the fragment's row group
  const int tig = lane % 4;                // and its thread in the group
  const int bh = blockIdx.x;               // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h * G / H;
  const float a = A[h];
  const int pg = P / 16;                   // 16-column groups of the state
  const int nblk = warp >= 6 ? 2 : 1;      // blocks of M this warp computes

  for (int i = tid; i < N * L.sp; i += kThreads) state[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kQ) {
    const int valid = min(kQ, S - s0);
    const int nr = (valid + 15) / 16;      // row tiles holding positions < S
    const long long row0 = static_cast<long long>(b) * S + s0;   // (b, s0) row

    // ---- stage the chunk in bf16 (zero-filled past S) ----------------------
    for (int idx = tid; idx < kQ * (P / 8); idx += kThreads) {
      const int q = idx / (P / 8);
      const int c = 8 * (idx - q * (P / 8));
      const long long src = (row0 + min(q, valid - 1)) * H + h;
      cp_async16(xs + q * L.xp + c, x + src * P + c, q < valid ? 16 : 0);
    }
    for (int idx = tid; idx < kQ * (N / 8); idx += kThreads) {
      const int q = idx / (N / 8);
      const int c = 8 * (idx - q * (N / 8));
      const long long src = ((row0 + min(q, valid - 1)) * G + g) * N + c;
      cp_async16(bs + q * L.np + c, Bm + src, q < valid ? 16 : 0);
      cp_async16(cs + q * L.np + c, Cm + src, q < valid ? 16 : 0);
    }
    cp_async_commit();
    if (tid < kQ) dts[tid] = tid < valid ? dt[(row0 + tid) * H + h] : 0.f;
    cp_async_wait<0>();
    __syncthreads();

    // ---- cum = cumsum(dt * A): a warp scan, two positions a lane ------------
    if (warp == 0) {
      const float d0 = dts[2 * lane] * a;
      const float d1 = dts[2 * lane + 1] * a;
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      const float c0 = excl + d0;
      const float c1 = c0 + d1;
      const float total = __shfl_sync(kFull, c1, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      ecum[2 * lane] = expf(c0);
      ecum[2 * lane + 1] = expf(c1);
      wj[2 * lane] = expf(total - c0) * dts[2 * lane];
      wj[2 * lane + 1] = expf(total - c1) * dts[2 * lane + 1];
    }

    // ---- C B^T on this warp's blocks of M (needs no cum, so it runs beside
    // the scan): s[e][t] holds keys 16 kk + 8 t + 2 tig + {0, 1} of rows
    // 16 r + grp (s[e][t][0..1]) and + 8 (s[e][t][2..3])
    float s[2][2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int r, kk;
      m_block(e == 0 ? warp : warp + 2, r, kk);
#pragma unroll
      for (int t = 0; t < 2; ++t) s[e][t][0] = s[e][t][1] = s[e][t][2] = s[e][t][3] = 0.f;
      if (e < nblk && r < nr) {
        for (int k0 = 0; k0 < N; k0 += 16) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, cs + (16 * r + lane % 16) * L.np + k0 + (lane / 16) * 8);
          ldmatrix_x4(bf, bs + (16 * kk + (lane / 16) * 8 + lane % 8) * L.np + k0 +
                              ((lane / 8) % 2) * 8);
          mma_bf16(s[e][0], af, bf[0], bf[1]);
          mma_bf16(s[e][1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
    const float total = cum[kQ - 1];

    // ---- M = C B^T o L o dt_j, L selected (never masked by a product), into
    // shared memory as two bf16 terms ----------------------------------------
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int r, kk;
      m_block(e == 0 ? warp : warp + 2, r, kk);
      if (e < nblk && r < nr) {
        const int i0 = 16 * r + grp;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = 16 * kk + 8 * t + 2 * tig;
          float m[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = i0 + 8 * (c / 2);
            const int jc = j + c % 2;
            m[c] = i >= jc ? s[e][t][c] * __expf(cum[i] - cum[jc]) * dts[jc] : 0.f;
          }
          uint32_t h0, l0, h1, l1;
          split_bf16(m[0], m[1], h0, l0);
          split_bf16(m[2], m[3], h1, l1);
          *reinterpret_cast<uint32_t*>(hi + i0 * L.mp + j) = h0;
          *reinterpret_cast<uint32_t*>(lo + i0 * L.mp + j) = l0;
          *reinterpret_cast<uint32_t*>(hi + (i0 + 8) * L.mp + j) = h1;
          *reinterpret_cast<uint32_t*>(lo + (i0 + 8) * L.mp + j) = l1;
        }
      }
    }
    __syncthreads();

    // ---- y = exp(cum) o (C state) + M x: a warp per 8 columns, all rows -----
    for (int p0 = 8 * warp; p0 < P; p0 += 8 * kWarps) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      // C state, the state split into two bf16 terms as it is read
      for (int k0 = 0; k0 < N; k0 += 16) {
        const float* st = state + (k0 + 2 * tig) * L.sp + p0 + grp;
        uint32_t h0, l0, h1, l1;
        split_bf16(st[0], st[L.sp], h0, l0);
        split_bf16(st[8 * L.sp], st[9 * L.sp], h1, l1);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r < nr) {
            uint32_t af[4];
            ldmatrix_x4(af, cs + (16 * r + lane % 16) * L.np + k0 + (lane / 16) * 8);
            mma_bf16(acc[r], af, h0, h1);
            mma_bf16(acc[r], af, l0, l1);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e0 = ecum[16 * r + grp];
        const float e1 = ecum[16 * r + grp + 8];
        acc[r][0] *= e0;
        acc[r][1] *= e0;
        acc[r][2] *= e1;
        acc[r][3] *= e1;
      }
      // + M x; bx holds the B fragments of key tiles 2 u and 2 u + 1
      uint32_t bx[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        ldmatrix_x4_trans(bx[u], xs + (32 * u + lane) * L.xp + p0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r < nr) {
#pragma unroll
          for (int kk = 0; kk <= r; ++kk) {
            uint32_t mh[4], ml[4];
            const int mo = (16 * r + lane % 16) * L.mp + 16 * kk + (lane / 16) * 8;
            ldmatrix_x4(mh, hi + mo);
            ldmatrix_x4(ml, lo + mo);
            const uint32_t b0 = bx[kk / 2][2 * (kk % 2)];
            const uint32_t b1 = bx[kk / 2][2 * (kk % 2) + 1];
            mma_bf16(acc[r], mh, b0, b1);
            mma_bf16(acc[r], ml, b0, b1);
          }
        }
      }
      // y rounded to bf16 once, rows past S not written
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i0 = 16 * r + grp;
        const int p = p0 + 2 * tig;
        if (i0 < valid)
          *reinterpret_cast<__nv_bfloat162*>(y + ((row0 + i0) * H + h) * P + p) =
              __floats2bfloat162_rn(acc[r][0], acc[r][1]);
        if (i0 + 8 < valid)
          *reinterpret_cast<__nv_bfloat162*>(y + ((row0 + i0 + 8) * H + h) * P + p) =
              __floats2bfloat162_rn(acc[r][2], acc[r][3]);
      }
    }
    __syncthreads();                       // every read of M and the old state is done

    // ---- w o x in two bf16 terms (over M's buffers): the update's B operand
    for (int idx = tid; idx < kQ * (P / 2); idx += kThreads) {
      const int q = idx / (P / 2);
      const int p = 2 * (idx - q * (P / 2));
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + q * L.xp + p));
      uint32_t h0, l0;
      split_bf16(wj[q] * xv.x, wj[q] * xv.y, h0, l0);
      *reinterpret_cast<uint32_t*>(hi + q * L.mp + p) = h0;
      *reinterpret_cast<uint32_t*>(lo + q * L.mp + p) = l0;
    }
    __syncthreads();

    // ---- state = exp(total) state + B^T (w o x), 16 x 16 tiles --------------
    const float decay = expf(total);
    for (int u = warp; u < (N / 16) * pg; u += kWarps) {
      const int n0 = 16 * (u / pg);
      const int p0 = 16 * (u % pg);
      float acc[2][4] = {};
      for (int k0 = 0; k0 < valid; k0 += 16) {      // positions past S add 0
        uint32_t af[4], bh[4], bl[4];
        ldmatrix_x4_trans(af, bs + (k0 + (lane / 16) * 8 + lane % 8) * L.np + n0 +
                                  ((lane / 8) % 2) * 8);
        const int xo = (k0 + ((lane / 8) % 2) * 8 + lane % 8) * L.mp + p0 + (lane / 16) * 8;
        ldmatrix_x4_trans(bh, hi + xo);
        ldmatrix_x4_trans(bl, lo + xo);
        mma_bf16(acc[0], af, bh[0], bh[1]);
        mma_bf16(acc[0], af, bl[0], bl[1]);
        mma_bf16(acc[1], af, bh[2], bh[3]);
        mma_bf16(acc[1], af, bl[2], bl[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float* s0p = state + (n0 + grp) * L.sp + p0 + 8 * t + 2 * tig;
        float* s1p = s0p + 8 * L.sp;
        float2 v0 = *reinterpret_cast<float2*>(s0p);
        float2 v1 = *reinterpret_cast<float2*>(s1p);
        v0.x = decay * v0.x + acc[t][0];
        v0.y = decay * v0.y + acc[t][1];
        v1.x = decay * v1.x + acc[t][2];
        v1.y = decay * v1.y + acc[t][3];
        *reinterpret_cast<float2*>(s0p) = v0;
        *reinterpret_cast<float2*>(s1p) = v1;
      }
    }
    __syncthreads();                       // before the next chunk overwrites the tiles
  }

  float* fs = final_state + static_cast<long long>(bh) * N * P;
  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P;
    fs[i] = state[n * L.sp + (i - n * P)];
  }
}

// Allow the block's dynamic shared memory; the bf16 kernel also asks for the
// largest shared-memory carveout, so that two of its blocks fit on an SM.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, bool max_carveout) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess || !max_carveout) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaError_t launch(int dtype, const void* x, const void* dt, const void* A, const void* B,
                   const void* C, void* y, void* final_state, int batch, int S, int H, int G,
                   int N, int P, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, P, dtype == 1);
  cudaError_t err;
  if (dtype == 0) {
    err = prepare(ssd_kernel<float>, smem, false);
    if (err != cudaSuccess) return err;
    ssd_kernel<float><<<batch * H, kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<const float*>(C), static_cast<float*>(y),
        static_cast<float*>(final_state), S, H, G, N, P);
  } else {
    err = prepare(ssd_kernel_bf16_tc, smem, true);
    if (err != cudaSuccess) return err;
    ssd_kernel_bf16_tc<<<batch * H, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(C), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(final_state), S, H, G, N, P);
  }
  return cudaGetLastError();
}

bool shape_ok(int dtype, int N, int P) {
  const int m = dtype == 1 ? 16 : 4;
  return N > 0 && P > 0 && N % m == 0 && P % m == 0;
}

}  // namespace

// dtype codes (x, B, C, y): 0 float32, 1 bfloat16.  dt and A are float32.
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, void* y, void* final_state, int batch, int S, int H,
                             int G, int N, int P, int dtype, void* stream) {
  // clear any error left by an earlier launch so the return value is ours
  cudaGetLastError();
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || (dtype != 0 && dtype != 1) ||
      !shape_ok(dtype, N, P))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(dtype, x, dt, A, B, C, y, final_state, batch, S, H, G, N, P,
                                 static_cast<cudaStream_t>(stream)));
}

// The shared memory one block of the kernel for (dtype, N, P) takes, and how
// many such blocks fit on one SM of the current device.
extern "C" int repro_ssd_occupancy(int N, int P, int dtype, long long* smem, int* blocks_per_sm) {
  cudaGetLastError();
  if ((dtype != 0 && dtype != 1) || !shape_ok(dtype, N, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(N, P, dtype == 1);
  *smem = static_cast<long long>(bytes);
  cudaError_t err = dtype == 0 ? prepare(ssd_kernel<float>, bytes, false)
                               : prepare(ssd_kernel_bf16_tc, bytes, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dtype == 0
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ssd_kernel<float>,
                                                            kThreads, bytes)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ssd_kernel_bf16_tc,
                                                            kThreads, bytes);
  return static_cast<int>(err);
}
