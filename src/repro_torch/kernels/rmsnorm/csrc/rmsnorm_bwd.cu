// RMSNorm backward for Hopper (sm_90a): with r = rsqrt(mean(x^2) + eps),
// x^ = x r and gs = g * scale,
//   dx     = r * (gs - x^ * mean(gs * x^))    (fp32, rounded once to x's dtype)
//   dscale = sum over rows of g * x^          (fp32, cast once to scale's dtype)
//
// The counterpart of XLA's compiled backward of the JAX norm
// (repro/models/norms.py::_rmsnorm, jnp under jax.checkpoint); the TPU kernel
// it sits beside is repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas, which has
// no backward of its own.  The statistics are recomputed from the saved x, as
// the JAX package's no-save checkpoint does.
//
// Bound on the card: bytes: x and g read once, dx written once (3 * rows * D
// * size), scale read and dscale written once.  Design (layout in
// rmsnorm.cuh):
//   - one read of x and g per row: a thread's NV <= 2 packs of each stay in
//     registers while the group reduces sum(x^2) and sum(g * scale * x)
//     together, then dx is written from them; the next row's packs are
//     loaded before this row's reduction, so the loads overlap it; a thread
//     keeps its columns over all its rows, so a 16-bit x's scale is loaded
//     once into registers (an fp32 x re-reads it from L1 each row);
//   - dscale without atomics, deterministically: a grid sized to fill the
//     card once (blocks per SM from the occupancy query) walks the rows; each
//     thread sums g * x^ for its columns in registers over its rows, the
//     block's row groups are added in group order through shared memory into
//     one fp32 partial row per block, and a second kernel sums the partial
//     rows of each column in a fixed order;
//   - blocks of at most 256 threads (with 512, ptxas spilled kernels near 64
//     registers to keep two blocks an SM);
//   - NV = 0 (rows wider than 2 * 256 packs): one row group per block, a
//     two-pass loop over the row, the block's partial row updated in device
//     memory by the thread that owns each column;
//   - VEC = 1: the scalar template, for a pointer that is not 16-byte aligned
//     or a width that is not a multiple of the pack.
#include "rmsnorm.cuh"

namespace {

constexpr int kBlock = 256;          // threads of a block; the most threads a row takes
constexpr int kSumSlices = 16;       // row slices a column is summed over in rmsnorm_colsum

// the packs of x and g a thread keeps for row `row` (nothing past the last row)
template <typename TX, int VEC, int NV>
__device__ __forceinline__ void load_row(const TX* x, const TX* g, long long row, long long rows,
                                         int D, int tpr, int t, Pack<TX, VEC> (&xv)[NV],
                                         Pack<TX, VEC> (&gv)[NV]) {
  if (row >= rows) return;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = j * tpr + t;
    if (i < D / VEC) {
      xv[j] = load<TX, VEC>(x + row * D + i * VEC);
      gv[j] = load<TX, VEC>(g + row * D + i * VEC);
    }
  }
}

template <typename TX, typename TS, int VEC, int NV>
__global__ void __launch_bounds__(kBlock) rmsnorm_bwd_kernel(
    const TX* __restrict__ x, const TS* __restrict__ scale, const TX* __restrict__ g,
    TX* __restrict__ dx, float* __restrict__ partial, long long rows, int D, int tpr,
    float inv_d, float eps) {
  __shared__ float red[2][kMaxWarps];
  const int nvec = D / VEC;
  const int groups = blockDim.x / tpr;
  const int gi = threadIdx.x / tpr;
  const int t = threadIdx.x - gi * tpr;
  float* prow = partial + static_cast<long long>(blockIdx.x) * D;
  const long long stride = static_cast<long long>(gridDim.x) * groups;

  if constexpr (NV > 0) {
    __shared__ float acc_smem[kBlock * NV * VEC];   // groups * D <= blockDim * NV * VEC
    float acc[NV][VEC] = {};
    // 16-bit x: the scale's packs held in registers over all the thread's
    // rows; fp32 x (four to a pack, twice the bytes of x and g in flight):
    // re-read from L1 each row, which keeps ptxas from spilling at 64
    // registers
    constexpr bool kHoldScale = sizeof(TX) == 2;
    float sc[kHoldScale ? NV : 1][VEC];
    if constexpr (kHoldScale) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = j * tpr + t;
        Pack<TS, VEC> s;
        if (i < nvec) s = load<TS, VEC>(scale + i * VEC);
#pragma unroll
        for (int k = 0; k < VEC; ++k) sc[j][k] = i < nvec ? to_f(s.v[k]) : 0.f;
      }
    }
    // every thread runs every iteration (group_sum holds barriers); a row
    // group past the last row computes nothing.  Each iteration issues the
    // next row's loads before it reduces this one, so they are in flight
    // through the reduction and the stores.
    Pack<TX, VEC> xv[NV], gv[NV];
    long long first = static_cast<long long>(blockIdx.x) * groups;
    load_row<TX, VEC, NV>(x, g, first + gi, rows, D, tpr, t, xv, gv);
    for (; first < rows; first += stride) {
      const long long row = first + gi;
      const bool valid = row < rows;
      const long long base = valid ? row * D : 0;
      Pack<TX, VEC> nx[NV], ng[NV];
      load_row<TX, VEC, NV>(x, g, row + stride, rows, D, tpr, t, nx, ng);
      float sr[NV][VEC];                           // this row's view of the scale
      float sums[2] = {0.f, 0.f};                  // sum x^2, sum g * scale * x
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = j * tpr + t;
        if (valid && i < nvec) {
          if constexpr (kHoldScale) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) sr[j][k] = sc[j][k];
          } else {
            const Pack<TS, VEC> sv = load<TS, VEC>(scale + i * VEC);
#pragma unroll
            for (int k = 0; k < VEC; ++k) sr[j][k] = to_f(sv.v[k]);
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float xf = to_f(xv[j].v[k]);
            sums[0] = fmaf(xf, xf, sums[0]);
            sums[1] = fmaf(to_f(gv[j].v[k]) * sr[j][k], xf, sums[1]);
          }
        }
      }
      group_sum<2>(sums, tpr, red);
      const float r = rsqrtf(sums[0] * inv_d + eps);
      const float c = sums[1] * r * inv_d;         // mean(gs * x^)
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = j * tpr + t;
        if (valid && i < nvec) {
          Pack<TX, VEC> o;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float xh = to_f(xv[j].v[k]) * r;
            const float gf = to_f(gv[j].v[k]);
            o.v[k] = from_f<TX>(r * (gf * sr[j][k] - xh * c));
            acc[j][k] = fmaf(gf, xh, acc[j][k]);
          }
          store<TX, VEC>(dx + base + i * VEC, o);
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          xv[j].v[k] = nx[j].v[k];
          gv[j].v[k] = ng[j].v[k];
        }
      }
    }
    if (groups == 1) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = j * tpr + t;
        if (i < nvec) {
          Pack<float, VEC> p;
#pragma unroll
          for (int k = 0; k < VEC; ++k) p.v[k] = acc[j][k];
          store<float, VEC>(prow + i * VEC, p);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = j * tpr + t;
        if (i < nvec) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc_smem[gi * D + i * VEC + k] = acc[j][k];
        }
      }
      __syncthreads();
      for (int col = threadIdx.x; col < D; col += blockDim.x) {
        float s = 0.f;
        for (int h = 0; h < groups; ++h) s += acc_smem[h * D + col];
        prow[col] = s;
      }
    }
  } else {
    // one row group per block: the thread owning pack i updates prow there
    for (int i = t; i < nvec; i += tpr) store<float, VEC>(prow + i * VEC, Pack<float, VEC>{});
    for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
      const long long base = row * D;
      float sums[2] = {0.f, 0.f};
      for (int i = t; i < nvec; i += tpr) {
        const Pack<TX, VEC> xv = load<TX, VEC>(x + base + i * VEC);
        const Pack<TX, VEC> gv = load<TX, VEC>(g + base + i * VEC);
        const Pack<TS, VEC> sv = load<TS, VEC>(scale + i * VEC);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xf = to_f(xv.v[k]);
          sums[0] = fmaf(xf, xf, sums[0]);
          sums[1] = fmaf(to_f(gv.v[k]) * to_f(sv.v[k]), xf, sums[1]);
        }
      }
      group_sum<2>(sums, tpr, red);
      const float r = rsqrtf(sums[0] * inv_d + eps);
      const float c = sums[1] * r * inv_d;
      for (int i = t; i < nvec; i += tpr) {
        const Pack<TX, VEC> xv = load<TX, VEC>(x + base + i * VEC);
        const Pack<TX, VEC> gv = load<TX, VEC>(g + base + i * VEC);
        const Pack<TS, VEC> sv = load<TS, VEC>(scale + i * VEC);
        Pack<float, VEC> p = load<float, VEC>(prow + i * VEC);
        Pack<TX, VEC> o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xh = to_f(xv.v[k]) * r;
          const float gf = to_f(gv.v[k]);
          o.v[k] = from_f<TX>(r * (gf * to_f(sv.v[k]) - xh * c));
          p.v[k] = fmaf(gf, xh, p.v[k]);
        }
        store<TX, VEC>(dx + base + i * VEC, o);
        store<float, VEC>(prow + i * VEC, p);
      }
    }
  }
}

// dscale[col] = sum over the P partial rows, in a fixed order: slice y of a
// column sums rows y, y + 16, ... (four running sums), then the 16 slices in
// order.  Blocks of 32 columns x 16 slices.
template <typename TS>
__global__ void __launch_bounds__(32 * kSumSlices) rmsnorm_colsum_kernel(
    const float* __restrict__ partial, TS* __restrict__ out, int P, int D) {
  __shared__ float part[kSumSlices][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (col < D) {
    const float* c = partial + col;
    const long long ld = D;
    int p = threadIdx.y;
    for (; p + 3 * kSumSlices < P; p += 4 * kSumSlices) {
      a0 += c[p * ld];
      a1 += c[(p + kSumSlices) * ld];
      a2 += c[(p + 2 * kSumSlices) * ld];
      a3 += c[(p + 3 * kSumSlices) * ld];
    }
    for (; p < P; p += kSumSlices) a0 += c[p * ld];
  }
  part[threadIdx.y][threadIdx.x] = (a0 + a1) + (a2 + a3);
  __syncthreads();
  if (threadIdx.y == 0 && col < D) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < kSumSlices; ++y) s += part[y][threadIdx.x];
    out[col] = from_f<TS>(s);
  }
}

int rows_per_block(int tpr) { return tpr >= kBlock ? 1 : kBlock / tpr; }

// the occupancy-sized grid of one template: enough blocks to fill every SM
// once, and no more blocks than row groups
struct GridOp {
  long long rows;
  int tpr;
  int* grid;
  template <typename TX, typename TS, int VEC, int NV>
  cudaError_t run() const {
    const int rpb = rows_per_block(tpr);
    int occ = 0, dev = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, rmsnorm_bwd_kernel<TX, TS, VEC, NV>, rpb * tpr, 0);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const long long need = (rows + rpb - 1) / rpb;
    const long long cap = static_cast<long long>(sms) * (occ > 0 ? occ : 1);
    *grid = static_cast<int>(need < cap ? need : cap);
    return cudaSuccess;
  }
};

struct LaunchOp {
  const void* x;
  const void* scale;
  const void* g;
  void* dx;
  float* partial;
  void* dscale;
  long long rows;
  int D;
  int tpr;
  int grid;
  float eps;
  cudaStream_t stream;
  template <typename TX, typename TS, int VEC, int NV>
  cudaError_t run() const {
    const int rpb = rows_per_block(tpr);
    if (NV > 0 && static_cast<long long>(NV) * tpr * VEC < D) return cudaErrorInvalidValue;
    if (NV == 0 && rpb != 1) return cudaErrorInvalidValue;
    if (grid < 1 || grid > (rows + rpb - 1) / rpb) return cudaErrorInvalidValue;
    rmsnorm_bwd_kernel<TX, TS, VEC, NV><<<grid, rpb * tpr, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TS*>(scale), static_cast<const TX*>(g),
        static_cast<TX*>(dx), partial, rows, D, tpr, 1.0f / static_cast<float>(D), eps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    rmsnorm_colsum_kernel<TS><<<(D + 31) / 32, dim3(32, kSumSlices), 0, stream>>>(
        partial, static_cast<TS*>(dscale), grid, D);
    return cudaGetLastError();
  }
};

template <typename Op, typename TX, typename TS, int VEC>
cudaError_t by_nv(const Op& op, int nv) {
  if constexpr (VEC == 1) {   // the scalar template: 2 elements a thread, or the loop
    switch (nv) {
      case 0: return op.template run<TX, TS, 1, 0>();
      case 2: return op.template run<TX, TS, 1, 2>();
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (nv) {
      case 0: return op.template run<TX, TS, VEC, 0>();
      case 1: return op.template run<TX, TS, VEC, 1>();
      case 2: return op.template run<TX, TS, VEC, 2>();
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename Op, typename TX, typename TS>
cudaError_t by_layout(const Op& op, int vec, int nv) {
  constexpr int kVec = 16 / sizeof(TX);
  if (vec == kVec) return by_nv<Op, TX, TS, kVec>(op, nv);
  if (vec == 1) return by_nv<Op, TX, TS, 1>(op, nv);
  return cudaErrorInvalidValue;
}

template <typename Op, typename TX>
cudaError_t by_scale(const Op& op, int s_dtype, int vec, int nv) {
  switch (s_dtype) {
    case 0: return by_layout<Op, TX, float>(op, vec, nv);
    case 1: return by_layout<Op, TX, __nv_bfloat16>(op, vec, nv);
    case 2: return by_layout<Op, TX, __half>(op, vec, nv);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Op>
cudaError_t dispatch(const Op& op, int x_dtype, int s_dtype, int vec, int nv) {
  switch (x_dtype) {
    case 0: return by_scale<Op, float>(op, s_dtype, vec, nv);
    case 1: return by_scale<Op, __nv_bfloat16>(op, s_dtype, vec, nv);
    case 2: return by_scale<Op, __half>(op, s_dtype, vec, nv);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_tpr(int tpr) {
  if (tpr < 1 || tpr > kBlock) return false;
  return tpr <= 32 ? (tpr & (tpr - 1)) == 0 : tpr % 32 == 0;
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

// The number of blocks (= fp32 partial rows of dscale) the backward of this
// template launches for `rows` rows; the caller allocates (grid, D) floats.
// Codes and template arguments as repro_rmsnorm_fwd's.
extern "C" int repro_rmsnorm_bwd_grid(long long rows, int D, int x_dtype, int s_dtype, int vec,
                                      int nv, int tpr, int* grid) {
  cudaGetLastError();
  if (rows <= 0 || D <= 0 || !valid_tpr(tpr) || grid == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(GridOp{rows, tpr, grid}, x_dtype, s_dtype, vec, nv));
}

// dx (x's dtype and shape) and dscale (scale's dtype, (D,)) from the saved x
// and scale and the output's grad g (x's dtype and shape); `partial` is
// scratch of (grid, D) floats.  Two launches: the rows, then the column sums.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale, const void* g, void* dx,
                                 void* partial, void* dscale, long long rows, int D, float eps,
                                 int x_dtype, int s_dtype, int vec, int nv, int tpr, int grid,
                                 void* stream) {
  cudaGetLastError();
  if (rows <= 0 || D <= 0 || !valid_tpr(tpr)) return static_cast<int>(cudaErrorInvalidValue);
  if (vec > 1 && (D % vec || misaligned(x) || misaligned(scale) || misaligned(g) ||
                  misaligned(dx) || misaligned(partial)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const LaunchOp op{x, scale, g, dx, static_cast<float*>(partial), dscale, rows, D, tpr, grid,
                    eps, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(op, x_dtype, s_dtype, vec, nv));
}

// ---------------------------------------------------------------------------
// The split-row backward (the forward's split form is in rmsnorm.cu): this
// rank holds D of the row's `width` columns, stat[row] is the all-reduced
// sum of x^2 over the whole row, r = rsqrt(stat / width + eps) and
// x^ = x r, gs = g * scale.
//   pass 1: dot[row] = sum over this rank's columns of gs * x^ (fp32); the
//           caller all-reduces it into T;
//   pass 2: dx = r * (gs - x^ * T / width) for this rank's columns, and
//           dscale for them through the same deterministic scheme as the
//           whole-row backward: one fp32 partial row per block, then
//           rmsnorm_colsum_kernel.
// Pass 2 keeps one row group per block (blockDim.x == tpr): each thread owns
// its columns over every row the block walks, so its dscale sums stay in
// registers (NV packs) or, for rows wider than two packs a thread (NV = 0),
// in the block's partial row in device memory; no barrier is needed.
namespace {

template <typename TX, typename TS, int VEC>
__global__ void __launch_bounds__(kBlock) rmsnorm_split_dot_kernel(
    const TX* __restrict__ x, const TS* __restrict__ scale, const TX* __restrict__ g,
    const float* __restrict__ stat, float* __restrict__ dot, long long rows, int D, int tpr,
    float inv_width, float eps) {
  __shared__ float red[1][kMaxWarps];
  const int nvec = D / VEC;
  const int t = threadIdx.x % tpr;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) +
                        threadIdx.x / tpr;
  const bool valid = row < rows;
  const long long base = valid ? row * D : 0;
  float s[1] = {0.f};
  for (int i = t; valid && i < nvec; i += tpr) {
    const Pack<TX, VEC> xv = load<TX, VEC>(x + base + i * VEC);
    const Pack<TX, VEC> gv = load<TX, VEC>(g + base + i * VEC);
    const Pack<TS, VEC> sv = load<TS, VEC>(scale + i * VEC);
#pragma unroll
    for (int k = 0; k < VEC; ++k) s[0] = fmaf(to_f(gv.v[k]) * to_f(sv.v[k]), to_f(xv.v[k]), s[0]);
  }
  group_sum<1>(s, tpr, red);
  if (valid && t == 0) dot[row] = s[0] * rsqrtf(stat[row] * inv_width + eps);
}

template <typename TX, typename TS, int VEC, int NV>
__global__ void __launch_bounds__(kBlock) rmsnorm_split_bwd_kernel(
    const TX* __restrict__ x, const TS* __restrict__ scale, const TX* __restrict__ g,
    const float* __restrict__ stat, const float* __restrict__ dot, TX* __restrict__ dx,
    float* __restrict__ partial, long long rows, int D, float inv_width, float eps) {
  const int nvec = D / VEC;
  const int t = threadIdx.x;
  const int tpr = blockDim.x;
  float* prow = partial + static_cast<long long>(blockIdx.x) * D;
  float acc[NV > 0 ? NV : 1][VEC] = {};
  if constexpr (NV == 0) {
    for (int i = t; i < nvec; i += tpr) store<float, VEC>(prow + i * VEC, Pack<float, VEC>{});
  }
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * D;
    const float r = rsqrtf(stat[row] * inv_width + eps);
    const float c = dot[row] * inv_width;          // mean(gs * x^) over the whole row
    int j = 0;
    for (int i = t; i < nvec; i += tpr, ++j) {
      const Pack<TX, VEC> xv = load<TX, VEC>(x + base + i * VEC);
      const Pack<TX, VEC> gv = load<TX, VEC>(g + base + i * VEC);
      const Pack<TS, VEC> sv = load<TS, VEC>(scale + i * VEC);
      Pack<TX, VEC> o;
      float ga[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xh = to_f(xv.v[k]) * r;
        const float gf = to_f(gv.v[k]);
        o.v[k] = from_f<TX>(r * (gf * to_f(sv.v[k]) - xh * c));
        ga[k] = gf * xh;
      }
      store<TX, VEC>(dx + base + i * VEC, o);
      if constexpr (NV > 0) {
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          if (jj == j) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[jj][k] += ga[k];
          }
        }
      } else {
        Pack<float, VEC> p = load<float, VEC>(prow + i * VEC);
#pragma unroll
        for (int k = 0; k < VEC; ++k) p.v[k] += ga[k];
        store<float, VEC>(prow + i * VEC, p);
      }
    }
  }
  if constexpr (NV > 0) {
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) {
      const int i = t + jj * tpr;
      if (i < nvec) {
        Pack<float, VEC> p;
#pragma unroll
        for (int k = 0; k < VEC; ++k) p.v[k] = acc[jj][k];
        store<float, VEC>(prow + i * VEC, p);
      }
    }
  }
}

struct SplitDotOp {
  const void* x;
  const void* scale;
  const void* g;
  const float* stat;
  float* dot;
  long long rows;
  int D;
  int tpr;
  float inv_width;
  float eps;
  cudaStream_t stream;
  template <typename TX, typename TS, int VEC, int NV>
  cudaError_t run() const {
    const int rpb = rows_per_block(tpr);
    const long long blocks = (rows + rpb - 1) / rpb;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_split_dot_kernel<TX, TS, VEC><<<static_cast<unsigned>(blocks), rpb * tpr, 0,
                                             stream>>>(
        static_cast<const TX*>(x), static_cast<const TS*>(scale), static_cast<const TX*>(g),
        stat, dot, rows, D, tpr, inv_width, eps);
    return cudaGetLastError();
  }
};

struct SplitBwdOp {
  const void* x;
  const void* scale;
  const void* g;
  const float* stat;
  const float* dot;
  void* dx;
  float* partial;
  void* dscale;
  long long rows;
  int D;
  int tpr;
  int grid;
  float inv_width;
  float eps;
  cudaStream_t stream;
  template <typename TX, typename TS, int VEC, int NV>
  cudaError_t run() const {
    if (NV > 0 && static_cast<long long>(NV) * tpr * VEC < D) return cudaErrorInvalidValue;
    if (grid < 1 || grid > rows) return cudaErrorInvalidValue;
    rmsnorm_split_bwd_kernel<TX, TS, VEC, NV><<<grid, tpr, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TS*>(scale), static_cast<const TX*>(g),
        stat, dot, static_cast<TX*>(dx), partial, rows, D, inv_width, eps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    rmsnorm_colsum_kernel<TS><<<(D + 31) / 32, dim3(32, kSumSlices), 0, stream>>>(
        partial, static_cast<TS*>(dscale), grid, D);
    return cudaGetLastError();
  }
};

}  // namespace

// Split pass 1 of the backward: dot[row] = sum over the D columns of
// g * scale * x * rsqrt(stat[row] / width + eps) (fp32).  Codes and
// template arguments as repro_rmsnorm_bwd's; nv is the template's (any of
// its values runs the same strided loop).
extern "C" int repro_rmsnorm_split_dot(const void* x, const void* scale, const void* g,
                                       const void* stat, void* dot, long long rows, int D,
                                       int width, float eps, int x_dtype, int s_dtype, int vec,
                                       int nv, int tpr, void* stream) {
  cudaGetLastError();
  if (rows <= 0 || D <= 0 || width < D || !valid_tpr(tpr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec > 1 && (D % vec || misaligned(x) || misaligned(scale) || misaligned(g)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const SplitDotOp op{x, scale, g, static_cast<const float*>(stat), static_cast<float*>(dot),
                      rows, D, tpr, 1.0f / static_cast<float>(width), eps,
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(op, x_dtype, s_dtype, vec, nv));
}

// Split pass 2 of the backward: dx (x's dtype and shape) and dscale
// (scale's dtype, (D,)) for this rank's columns, from stat and the
// all-reduced dot (both (rows,) fp32); `partial` is scratch of (grid, D)
// floats, grid <= rows blocks of tpr threads.  Two launches: the rows, then
// the column sums.
extern "C" int repro_rmsnorm_split_bwd(const void* x, const void* scale, const void* g,
                                       const void* stat, const void* dot, void* dx,
                                       void* partial, void* dscale, long long rows, int D,
                                       int width, float eps, int x_dtype, int s_dtype, int vec,
                                       int nv, int tpr, int grid, void* stream) {
  cudaGetLastError();
  if (rows <= 0 || D <= 0 || width < D || !valid_tpr(tpr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec > 1 && (D % vec || misaligned(x) || misaligned(scale) || misaligned(g) ||
                  misaligned(dx) || misaligned(partial)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const SplitBwdOp op{x, scale, g, static_cast<const float*>(stat),
                      static_cast<const float*>(dot), dx, static_cast<float*>(partial), dscale,
                      rows, D, tpr, grid, 1.0f / static_cast<float>(width), eps,
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(op, x_dtype, s_dtype, vec, nv));
}
