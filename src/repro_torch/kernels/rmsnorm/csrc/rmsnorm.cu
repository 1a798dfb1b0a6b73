// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale,
// and the gated form of Mamba2's gate norm, y = rmsnorm(x * silu(z)).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas
// (body _rmsnorm_kernel).  Same arithmetic: fp32 sum of squares over the last
// dim, output rounded once to x's dtype.  The gate rounds where the plain
// composition x * F.silu(z) rounds: silu(z) to x's dtype, then the product to
// x's dtype, and the statistics are taken on that product.
//
// Bound on the card: bytes.  Each element is read once and written once with a
// handful of flops, so the roofline is (2 (3 gated) * rows * D * size + D *
// scale_size) / 3.35 TB/s.  Design (layout in rmsnorm.cuh):
//   - one read of the row: each thread loads its NV packs of 16 bytes (8 bf16
//     or 4 fp32) with vector instructions, neighbouring threads on
//     neighbouring addresses, all of them before the first use, keeps them in
//     registers through the sum of squares and writes the output from them;
//   - the work sized to the width: narrow rows (the qk-norm's 64/128, decode
//     rows) pack several rows per warp or one warp per row with no block
//     barrier; a wide row spreads over as many warps as hold it at two packs
//     a thread (small units keep many rows in flight per SM: on the H100 two
//     packs ran ahead of one, four and eight), and those warps meet once in
//     shared memory; four or eight packs only where 512 threads of two would
//     not hold the row, and never gated (x and z both stay in registers);
//   - NV = 0 is the compile-time branch for rows wider than the register
//     template holds (more than 8 * 512 packs): a vectorised two-pass loop that
//     re-reads the row from cache for the output;
//   - VEC = 1 is the scalar template (two elements a thread, or the loop),
//     taken for a pointer that is not 16-byte aligned or a width that is not
//     a multiple of the pack;
//   - no IEEE division or square root (their slow paths are calls that spill):
//     1/D comes from the host, rsqrtf and the fast division of silu are
//     within an ulp or two of fp32.
#include "rmsnorm.cuh"

#include <initializer_list>

namespace {

struct FwdArgs {
  const void* x;
  const void* z;       // the gate, or nullptr
  const void* scale;
  void* out;
  long long rows;
  int D;
  int tpr;
  float eps;
  cudaStream_t stream;
};

// x * silu(z) for one pack, rounded as torch rounds it: silu(z) to x's
// dtype, then the product to x's dtype (silu's division is the fast one: no
// slow-path call, within an ulp of fp32's)
template <typename TX, int VEC>
__device__ __forceinline__ Pack<TX, VEC> gate(Pack<TX, VEC> v, const Pack<TX, VEC>& z) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float zf = to_f(z.v[k]);
    const float silu = round_to<TX>(__fdividef(zf, 1.0f + expf(-zf)));
    v.v[k] = from_f<TX>(to_f(v.v[k]) * silu);
  }
  return v;
}

// one pack of the row: x, or the gated product
template <typename TX, int VEC, bool GATED>
__device__ __forceinline__ Pack<TX, VEC> row_pack(const TX* x, const TX* z, int off) {
  if constexpr (GATED) return gate<TX, VEC>(load<TX, VEC>(x + off), load<TX, VEC>(z + off));
  return load<TX, VEC>(x + off);
}

template <typename TX, int VEC>
__device__ __forceinline__ float sum_sq(const Pack<TX, VEC>& v, float acc) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float f = to_f(v.v[k]);
    acc = fmaf(f, f, acc);
  }
  return acc;
}

template <typename TX, typename TS, int VEC>
__device__ __forceinline__ void write_pack(TX* out, const TS* scale, int off,
                                           const Pack<TX, VEC>& v, float inv) {
  const Pack<TS, VEC> s = load<TS, VEC>(scale + off);
  Pack<TX, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.v[k] = from_f<TX>(to_f(v.v[k]) * inv * to_f(s.v[k]));
  store<TX, VEC>(out + off, o);
}

template <typename TX, typename TS, int VEC, int NV, bool GATED>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_kernel(
    const TX* __restrict__ x, const TX* __restrict__ z, const TS* __restrict__ scale,
    TX* __restrict__ out, long long rows, int D, int tpr, float inv_d, float eps) {
  __shared__ float red[1][kMaxWarps];
  const int nvec = D / VEC;
  const int t = threadIdx.x % tpr;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) +
                        threadIdx.x / tpr;
  const bool valid = row < rows;
  const long long base = valid ? row * D : 0;
  const TX* xr = x + base;
  const TX* zr = GATED ? z + base : nullptr;
  TX* outr = out + base;

  float ss[1] = {0.f};
  if constexpr (NV > 0) {
    // every load of the row issued before the first use
    Pack<TX, VEC> v[NV], g[GATED ? NV : 1];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = j * tpr + t;
      if (valid && i < nvec) {
        v[j] = load<TX, VEC>(xr + i * VEC);
        if constexpr (GATED) g[j] = load<TX, VEC>(zr + i * VEC);
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = j * tpr + t;
      if (valid && i < nvec) {
        if constexpr (GATED) v[j] = gate<TX, VEC>(v[j], g[j]);
        ss[0] = sum_sq<TX, VEC>(v[j], ss[0]);
      }
    }
    group_sum<1>(ss, tpr, red);
    const float inv = rsqrtf(ss[0] * inv_d + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = j * tpr + t;
      if (valid && i < nvec) write_pack<TX, TS, VEC>(outr, scale, i * VEC, v[j], inv);
    }
  } else {
    for (int i = t; valid && i < nvec; i += tpr)
      ss[0] = sum_sq<TX, VEC>(row_pack<TX, VEC, GATED>(xr, zr, i * VEC), ss[0]);
    group_sum<1>(ss, tpr, red);
    const float inv = rsqrtf(ss[0] * inv_d + eps);
    for (int i = t; valid && i < nvec; i += tpr)
      write_pack<TX, TS, VEC>(outr, scale, i * VEC, row_pack<TX, VEC, GATED>(xr, zr, i * VEC),
                              inv);
  }
}

template <typename TX, typename TS, int VEC, int NV, bool GATED>
cudaError_t launch(const FwdArgs& a) {
  if (NV > 0 && static_cast<long long>(NV) * a.tpr * VEC < a.D) return cudaErrorInvalidValue;
  const int rows_per_block = a.tpr >= 256 ? 1 : 256 / a.tpr;
  const long long blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_kernel<TX, TS, VEC, NV, GATED>
      <<<static_cast<unsigned>(blocks), rows_per_block * a.tpr, 0, a.stream>>>(
          static_cast<const TX*>(a.x), static_cast<const TX*>(a.z),
          static_cast<const TS*>(a.scale), static_cast<TX*>(a.out), a.rows, a.D, a.tpr,
          1.0f / static_cast<float>(a.D), a.eps);
  return cudaGetLastError();
}

template <typename TX, typename TS, int VEC, bool GATED>
cudaError_t by_nv(const FwdArgs& a, int nv) {
  if constexpr (VEC == 1) {   // the scalar template: 2 elements a thread, or the loop
    switch (nv) {
      case 0: return launch<TX, TS, VEC, 0, GATED>(a);
      case 2: return launch<TX, TS, VEC, 2, GATED>(a);
      default: return cudaErrorInvalidValue;
    }
  } else if constexpr (GATED) {   // x and z both in registers: two packs of each
    switch (nv) {
      case 0: return launch<TX, TS, VEC, 0, GATED>(a);
      case 1: return launch<TX, TS, VEC, 1, GATED>(a);
      case 2: return launch<TX, TS, VEC, 2, GATED>(a);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (nv) {
      case 0: return launch<TX, TS, VEC, 0, GATED>(a);
      case 1: return launch<TX, TS, VEC, 1, GATED>(a);
      case 2: return launch<TX, TS, VEC, 2, GATED>(a);
      case 4: return launch<TX, TS, VEC, 4, GATED>(a);
      case 8: return launch<TX, TS, VEC, 8, GATED>(a);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename TX, typename TS>
cudaError_t by_layout(const FwdArgs& a, int vec, int nv) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool gated = a.z != nullptr;
  if (vec == kVec) {
    const auto misaligned = [](const void* p) {
      return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
    };
    if (a.D % kVec || misaligned(a.x) || misaligned(a.scale) || misaligned(a.out) ||
        (gated && misaligned(a.z)))
      return cudaErrorMisalignedAddress;
    return gated ? by_nv<TX, TS, kVec, true>(a, nv) : by_nv<TX, TS, kVec, false>(a, nv);
  }
  if (vec == 1) return gated ? by_nv<TX, TS, 1, true>(a, nv) : by_nv<TX, TS, 1, false>(a, nv);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t by_scale(const FwdArgs& a, int s_dtype, int vec, int nv) {
  switch (s_dtype) {
    case 0: return by_layout<TX, float>(a, vec, nv);
    case 1: return by_layout<TX, __nv_bfloat16>(a, vec, nv);
    case 2: return by_layout<TX, __half>(a, vec, nv);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_tpr(int tpr) {
  if (tpr < 1 || tpr > kMaxThreads) return false;
  return tpr <= 32 ? (tpr & (tpr - 1)) == 0 : tpr % 32 == 0;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16.  z (the gate, x's dtype and
// shape) may be null.  vec is 16 / sizeof(x) (vector templates) or 1
// (scalar); nv the packs a thread keeps in registers (0: the two-pass loop);
// tpr the threads per row.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* z, const void* scale, void* out,
                                 long long rows, int D, float eps, int x_dtype, int s_dtype,
                                 int vec, int nv, int tpr, void* stream) {
  // clear any error left by an earlier launch so the return value is ours
  cudaGetLastError();
  if (rows <= 0 || D <= 0 || !valid_tpr(tpr)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{x, z, scale, out, rows, D, tpr, eps, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (x_dtype) {
    case 0: err = by_scale<float>(a, s_dtype, vec, nv); break;
    case 1: err = by_scale<__nv_bfloat16>(a, s_dtype, vec, nv); break;
    case 2: err = by_scale<__half>(a, s_dtype, vec, nv); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// The split-row form, for a row whose columns are split over the ranks of a
// tensor-parallel group (Mamba2's gate norm over d_inner).  Each rank holds
// D of the row's `width` columns.  Pass 1 writes each row's fp32 sum of x^2
// over this rank's columns; the caller all-reduces those sums into S; pass 2
// normalises this rank's columns with r = rsqrt(S / width + eps), the mean
// over the whole row, and scales them by this rank's slice of the scale.
// The arithmetic is the whole-row kernel's: fp32 sums, rsqrtf, the output
// rounded once to x's dtype.  A simple layout: each row group walks its
// columns in 16-byte packs (or scalars) with a stride of tpr packs, the
// threads of a row on neighbouring packs; tpr as _template picks it.
namespace {

template <typename TX, int VEC>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_split_sumsq_kernel(
    const TX* __restrict__ x, float* __restrict__ ss, long long rows, int D, int tpr) {
  __shared__ float red[1][kMaxWarps];
  const int nvec = D / VEC;
  const int t = threadIdx.x % tpr;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) +
                        threadIdx.x / tpr;
  const bool valid = row < rows;
  const TX* xr = x + (valid ? row * D : 0);
  float s[1] = {0.f};
  for (int i = t; valid && i < nvec; i += tpr)
    s[0] = sum_sq<TX, VEC>(load<TX, VEC>(xr + i * VEC), s[0]);
  group_sum<1>(s, tpr, red);
  if (valid && t == 0) ss[row] = s[0];
}

template <typename TX, typename TS, int VEC>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_split_fwd_kernel(
    const TX* __restrict__ x, const TS* __restrict__ scale, const float* __restrict__ stat,
    TX* __restrict__ out, long long rows, int D, int tpr, float inv_width, float eps) {
  const int nvec = D / VEC;
  const int t = threadIdx.x % tpr;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) +
                        threadIdx.x / tpr;
  if (row >= rows) return;                 // no barrier follows
  const float inv = rsqrtf(stat[row] * inv_width + eps);
  const long long base = row * D;
  for (int i = t; i < nvec; i += tpr)
    write_pack<TX, TS, VEC>(out + base, scale, i * VEC, load<TX, VEC>(x + base + i * VEC), inv);
}

struct SplitGeom {
  long long rows;
  int D;
  int tpr;
  cudaStream_t stream;
  long long blocks() const { return (rows + rows_per_block() - 1) / rows_per_block(); }
  int rows_per_block() const { return tpr >= 256 ? 1 : 256 / tpr; }
};

struct SumSqOp {
  SplitGeom geo;
  const void* x;
  float* ss;
  template <typename TX, typename TS, int VEC>
  cudaError_t run() const {
    if (geo.blocks() > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_split_sumsq_kernel<TX, VEC>
        <<<static_cast<unsigned>(geo.blocks()), geo.rows_per_block() * geo.tpr, 0, geo.stream>>>(
            static_cast<const TX*>(x), ss, geo.rows, geo.D, geo.tpr);
    return cudaGetLastError();
  }
};

struct SplitFwdOp {
  SplitGeom geo;
  const void* x;
  const void* scale;
  const float* stat;
  void* out;
  float inv_width;
  float eps;
  template <typename TX, typename TS, int VEC>
  cudaError_t run() const {
    if (geo.blocks() > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_split_fwd_kernel<TX, TS, VEC>
        <<<static_cast<unsigned>(geo.blocks()), geo.rows_per_block() * geo.tpr, 0, geo.stream>>>(
            static_cast<const TX*>(x), static_cast<const TS*>(scale), stat,
            static_cast<TX*>(out), geo.rows, geo.D, geo.tpr, inv_width, eps);
    return cudaGetLastError();
  }
};

template <typename Op, typename TX, typename TS>
cudaError_t split_by_vec(const Op& op, int vec) {
  constexpr int kVec = 16 / sizeof(TX);
  if (vec == kVec) return op.template run<TX, TS, kVec>();
  if (vec == 1) return op.template run<TX, TS, 1>();
  return cudaErrorInvalidValue;
}

template <typename Op, typename TX>
cudaError_t split_by_scale(const Op& op, int s_dtype, int vec) {
  switch (s_dtype) {
    case 0: return split_by_vec<Op, TX, float>(op, vec);
    case 1: return split_by_vec<Op, TX, __nv_bfloat16>(op, vec);
    case 2: return split_by_vec<Op, TX, __half>(op, vec);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Op>
cudaError_t split_dispatch(const Op& op, int x_dtype, int s_dtype, int vec) {
  switch (x_dtype) {
    case 0: return split_by_scale<Op, float>(op, s_dtype, vec);
    case 1: return split_by_scale<Op, __nv_bfloat16>(op, s_dtype, vec);
    case 2: return split_by_scale<Op, __half>(op, s_dtype, vec);
    default: return cudaErrorInvalidValue;
  }
}

bool split_args_ok(long long rows, int D, int tpr, int vec,
                   std::initializer_list<const void*> ptrs) {
  if (rows <= 0 || D <= 0 || !valid_tpr(tpr) || vec < 1 || D % vec) return false;
  if (vec > 1) {
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  }
  return true;
}

}  // namespace

// Pass 1: ss[row] = the fp32 sum of x^2 over the row's D columns (rows x D
// contiguous).  vec: 16 / sizeof(x) (x 16-byte aligned) or 1; tpr the
// threads per row.
extern "C" int repro_rmsnorm_split_sumsq(const void* x, void* ss, long long rows, int D,
                                         int x_dtype, int vec, int tpr, void* stream) {
  cudaGetLastError();
  if (!split_args_ok(rows, D, tpr, vec, {x})) return static_cast<int>(cudaErrorInvalidValue);
  const SumSqOp op{{rows, D, tpr, static_cast<cudaStream_t>(stream)}, x,
                   static_cast<float*>(ss)};
  return static_cast<int>(split_dispatch(op, x_dtype, 0, vec));
}

// Pass 2: out = x * rsqrt(stat / width + eps) * scale over this rank's D
// columns; stat (rows,) fp32 is the row's sum of x^2 over all `width`
// columns; scale (D,) this rank's slice.
extern "C" int repro_rmsnorm_split_fwd(const void* x, const void* scale, const void* stat,
                                       void* out, long long rows, int D, int width, float eps,
                                       int x_dtype, int s_dtype, int vec, int tpr, void* stream) {
  cudaGetLastError();
  if (width < D || !split_args_ok(rows, D, tpr, vec, {x, scale, out}))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitFwdOp op{{rows, D, tpr, static_cast<cudaStream_t>(stream)}, x, scale,
                      static_cast<const float*>(stat), out, 1.0f / static_cast<float>(width),
                      eps};
  return static_cast<int>(split_dispatch(op, x_dtype, s_dtype, vec));
}
