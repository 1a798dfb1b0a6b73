// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention_fwd (body
// _flash_fwd_kernel).  Same function: softmax(q k^T * hd^-1/2 + mask) v with
// fp32 scores and an fp32 online-softmax state (acc, m, l) carried across
// key tiles, a causal mask from row/column indices or from explicit
// q_pos/k_pos (k_pos <= q_pos), the finite NEG_INF = -0.7 * f32max for masked
// scores (a fully masked row yields the mean of v), keys past Sk weighing
// exactly 0, l clamped at 1e-30, and optional (m, l) residuals.
//
// Layout: q (B, Sq, H, HD), k/v (B, Sk, KV, HD) with H % KV == 0 (query
// head h reads kv head h / (H / KV)), all contiguous; out like q;
// positions (Sq,)/(Sk,) or (B, S) int32; m/l (B, H, Sq) fp32.
//
// What bounds it on the H100, at the llama serving shapes (hd 64, 32 q / 8
// kv heads): a decode step (one q row per slot against its cached keys) is
// bytes-bound — each K/V byte feeds 4 query heads' worth of ~1 flop; a
// 256-row prefill chunk is operations-bound (1024 packed rows per kv head
// against 768 visible keys).  The design:
//   * Packed rows.  A block owns one (batch, kv head) and a tile of packed
//     rows, a packed row being one (q position, query head of the group)
//     pair.  The H/KV heads that share a kv head share every K/V tile the
//     block loads, so compact K/V is read once per block, not once per head.
//   * bf16 on tensor cores.  S = Q K^T and O += P V are
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix (V with
//     .trans).  S stays in registers, the online softmax runs on the
//     accumulator fragments (row max and sum across each quad), and P is
//     rounded to bf16 in registers as the A operand of P V, as in
//     FlashAttention-2.  l sums the fp32 probabilities.  mma.sync, not
//     wgmma: these calls are small and latency-bound, and wgmma's 64-row
//     minimum would leave 60 of 64 rows empty at decode.  fp32 inputs run
//     the same loop with CUDA-core FMAs on the same fragment layout (no
//     TF32), so fp32 stays true fp32.
//   * K/V tiles of 64 keys stream through a ring of 2-4 shared-memory
//     stages with cp.async (16 bytes a thread), as many as leave room for
//     two blocks on an SM; rows padded by 16 bytes so ldmatrix hits 8
//     distinct bank groups.  Keys past Sk are zero-filled.
//   * Masked tiles are skipped, exactly.  A tile whose smallest k_pos
//     exceeds the largest q_pos of the block's rows (the INT32_MAX keys at or
//     past kv_len included) is never loaded.  That is exact only if every
//     row of the block sees some key, so the block first checks that no row's
//     q_pos lies below the smallest k_pos of its batch row; if one does (a
//     fully masked row, which must come out as the mean of v), the block runs
//     every tile.  A tile every row sees in full (all its k_pos at most the
//     smallest q_pos of the block, none past Sk) skips the mask arithmetic.
//   * Split-K at decode.  With <= 16 packed rows per (batch, kv head) a block
//     is 16 rows, its 4 warps split each tile's keys and merge in shared
//     memory, and the key range is split over blocks besides (B * KV pairs
//     alone are fewer than the 132 SMs); flash_fwd_split_merge then merges
//     the splits' (m, l, acc) with the online-softmax rule.  Larger row
//     counts use 64-row blocks and split only past 256 tiles of keys: 4
//     warps of 16 rows, or, where that leaves SMs with fewer than ~1.5
//     blocks (the 256-row prefill chunk: 128 blocks), 8 warps, two per 16
//     rows on half of each tile's keys each, merged as at decode.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kMergeWarps = 4;             // the split merge: a warp per row
constexpr int kTileK = 64;                 // keys per K/V tile
constexpr int kMaxTiles = 256;             // tiles one block may walk; longer ranges split
// the JAX package's NEG_INF: the double -0.7 * f32max rounded to float
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);
constexpr float kLog2e = 1.4426950408889634f;

constexpr size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

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
  float* part_o;              // split partials (nsplit > 1): (nsplit, B*H*Sq, HD)
  float* part_m;              // (nsplit, B*H*Sq)
  float* part_l;
  int B, H, KV, G, Sq, Sk;
  int causal;
  int nsplit, tiles_per_split;
  float scale;
};

// ------------------------------------------------------------ stores

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------ layout

// WR warps along rows (16 rows each) x WK warps along the keys of a tile.
template <typename T, int HD, int WR, int WK>
struct Layout {
  static constexpr int kWarps = WR * WK;
  static constexpr int kRows = 16 * WR;
  static constexpr int kKW = kTileK / WK;                 // keys of a tile per warp
  static constexpr int kPitch = HD + 16 / sizeof(T);      // +16 bytes a row
  static constexpr int kPPitch = kKW + 4;                 // fp32 P rows (fp32 path)
  static constexpr size_t tile_bytes = sizeof(T) * kTileK * kPitch;
  static constexpr size_t q_bytes = align16(sizeof(T) * kRows * kPitch);
  static constexpr size_t p_bytes = sizeof(T) == 4 ? sizeof(float) * kWarps * 16 * kPPitch : 0;
  // the warps' (acc, m, l) fragments when WK > 1, over the K/V stages after the loop
  static constexpr int kMergeRegs = HD / 2 + 4;
  static constexpr size_t merge_bytes = WK > 1 ? sizeof(float) * kWarps * kMergeRegs * 32 : 0;
  static constexpr int kRed = 4 * kWarps + 4;             // ints of block reductions
  static constexpr size_t bytes(int stages) {
    return align16(q_bytes + 2 * stages * tile_bytes +
                   align16(sizeof(int) * (stages * kTileK + kMaxTiles + kRed)) + p_bytes);
  }
  // K/V tiles in flight: as many (at most 4) as leave room for two blocks per SM
  static constexpr size_t kTwoPerSM = 113 * 1024;
  static constexpr int kStages = bytes(4) <= kTwoPerSM ? 4 : bytes(3) <= kTwoPerSM ? 3 : 2;
  static constexpr size_t q_off = 0;
  static constexpr size_t kv_off = q_bytes;
  // K stage 0, V stage 0, K stage 1, V stage 1, ...
  static constexpr size_t kp_off = kv_off + 2 * kStages * tile_bytes;
  static constexpr size_t list_off = kp_off + sizeof(int) * kStages * kTileK;
  static constexpr size_t red_off = list_off + sizeof(int) * kMaxTiles;
  static constexpr size_t p_off = align16(red_off + sizeof(int) * kRed);
  static constexpr size_t total = bytes(kStages);
  static_assert(p_off + p_bytes <= total, "layout");
  static_assert(merge_bytes <= 2 * kStages * tile_bytes, "merge buffer overlaps positions");
};

// ------------------------------------------------------------ products

// S (16 rows x kKW keys of this warp) from Q and a K tile, in the mma
// accumulator layout: s[n][0..1] row lane/4, s[n][2..3] row lane/4 + 8,
// keys n*8 + 2*(lane%4) + {0, 1}.
template <int HD, int kNT, int kPitch>
__device__ __forceinline__ void scores(float (&s)[kNT][4], const uint32_t (&qf)[HD / 16][4],
                                       const __nv_bfloat16* ks, const __nv_bfloat16*, int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < kNT; n += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, ks + (n * 8 + (lane / 16) * 8 + (lane % 8)) * kPitch + kk * 16 +
                         ((lane / 8) % 2) * 8);
      mma_bf16(s[n], qf[kk], b[0], b[1]);
      mma_bf16(s[n + 1], qf[kk], b[2], b[3]);
    }
  }
}

template <int HD, int kNT, int kPitch>
__device__ __forceinline__ void scores(float (&s)[kNT][4], const uint32_t (&)[HD / 16][4],
                                       const float* ks, const float* qw, int lane) {
  const float* qa = qw + (lane / 4) * kPitch;
  const float* qb = qa + 8 * kPitch;
  const float* kc = ks + 2 * (lane % 4) * kPitch;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(qa + d);
    const float4 bq = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float4 k0 = *reinterpret_cast<const float4*>(kc + n * 8 * kPitch + d);
      const float4 k1 = *reinterpret_cast<const float4*>(kc + (n * 8 + 1) * kPitch + d);
      s[n][0] = fmaf(a.w, k0.w, fmaf(a.z, k0.z, fmaf(a.y, k0.y, fmaf(a.x, k0.x, s[n][0]))));
      s[n][1] = fmaf(a.w, k1.w, fmaf(a.z, k1.z, fmaf(a.y, k1.y, fmaf(a.x, k1.x, s[n][1]))));
      s[n][2] = fmaf(bq.w, k0.w, fmaf(bq.z, k0.z, fmaf(bq.y, k0.y, fmaf(bq.x, k0.x, s[n][2]))));
      s[n][3] = fmaf(bq.w, k1.w, fmaf(bq.z, k1.z, fmaf(bq.y, k1.y, fmaf(bq.x, k1.x, s[n][3]))));
    }
  }
}

// o (16 rows x HD, accumulator layout) += P (probabilities in s) * V tile
template <int HD, int kNT, int kPitch, int kPPitch>
__device__ __forceinline__ void accumulate(float (&o)[HD / 8][4], const float (&s)[kNT][4],
                                           const __nv_bfloat16* vs, float*, int lane) {
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int d = 0; d < HD / 8; d += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (kk * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * kPitch + d * 8 +
                               (lane / 16) * 8);
      mma_bf16(o[d], a, b[0], b[1]);
      mma_bf16(o[d + 1], a, b[2], b[3]);
    }
  }
}

template <int HD, int kNT, int kPitch, int kPPitch>
__device__ __forceinline__ void accumulate(float (&o)[HD / 8][4], const float (&s)[kNT][4],
                                           const float* vs, float* pw, int lane) {
  const int ra = lane / 4;
  const int c = 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    store2(pw + ra * kPPitch + n * 8 + c, s[n][0], s[n][1]);
    store2(pw + (ra + 8) * kPPitch + n * 8 + c, s[n][2], s[n][3]);
  }
  __syncwarp();
#pragma unroll 4
  for (int j = 0; j < kNT * 8; ++j) {
    const float pa = pw[ra * kPPitch + j];
    const float pb = pw[(ra + 8) * kPPitch + j];
    const float* vr = vs + j * kPitch + c;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const float2 vv = *reinterpret_cast<const float2*>(vr + d * 8);
      o[d][0] = fmaf(pa, vv.x, o[d][0]);
      o[d][1] = fmaf(pa, vv.y, o[d][1]);
      o[d][2] = fmaf(pb, vv.x, o[d][2]);
      o[d][3] = fmaf(pb, vv.y, o[d][3]);
    }
  }
  __syncwarp();                                      // P read before the next tile writes it
}

// ------------------------------------------------------------ the kernel

template <typename T, int HD, int WR, int WK>
__global__ void __launch_bounds__(32 * WR * WK) flash_fwd_kernel(const Params p) {
  using L = Layout<T, HD, WR, WK>;
  constexpr int kWarps = L::kWarps;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kRows = L::kRows;
  constexpr int kKW = L::kKW;
  constexpr int kNT = kKW / 8;                       // 8-key column tiles of S per warp
  constexpr int kDT = HD / 8;                        // 8-column tiles of O
  constexpr int kPitch = L::kPitch;
  constexpr int kChunk = 16 / sizeof(T);             // elements per 16-byte copy
  constexpr int kCPR = HD / kChunk;                  // copies per row
  constexpr bool kBf16 = sizeof(T) == 2;
  static_assert(kNT % 2 == 0 && kDT % 2 == 0 && HD % 16 == 0, "tile shapes");

  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  int* KPs = reinterpret_cast<int*>(smem + L::kp_off);
  int* tiles = reinterpret_cast<int*>(smem + L::list_off);
  int* red = reinterpret_cast<int*>(smem + L::red_off);
  auto k_tile = [&](int stage) { return reinterpret_cast<T*>(smem + L::kv_off + 2 * stage * L::tile_bytes); };
  auto v_tile = [&](int stage) { return reinterpret_cast<T*>(smem + L::kv_off + (2 * stage + 1) * L::tile_bytes); };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wr = warp / WK;
  const int wk = warp % WK;
  const int b = blockIdx.y / p.KV;
  const int kvh = blockIdx.y % p.KV;
  const int split = blockIdx.z;
  const int nrows = p.G * p.Sq;                      // packed rows of this (b, kv head)
  const int r0 = blockIdx.x * kRows;
  const int ntiles = (p.Sk + kTileK - 1) / kTileK;
  const int t_begin = split * p.tiles_per_split;
  const int t_end = min(ntiles, t_begin + p.tiles_per_split);
  const long long key_stride = static_cast<long long>(p.KV) * HD;
  const T* kb = static_cast<const T*>(p.k) + (static_cast<long long>(b) * p.Sk * p.KV + kvh) * HD;
  const T* vb = static_cast<const T*>(p.v) + (static_cast<long long>(b) * p.Sk * p.KV + kvh) * HD;
  const int* kpos = p.kpos ? p.kpos + b * p.kpos_bstride : nullptr;
  auto q_position = [&](int pr) {
    const int qi = pr / p.G;
    return p.qpos ? p.qpos[b * p.qpos_bstride + qi] : qi;
  };
  auto k_position = [&](int j) { return kpos ? kpos[j] : j; };

  // 1. the block's Q rows (zero past the last packed row)
  for (int i = tid; i < kRows * kCPR; i += kThreads) {
    const int r = i / kCPR;
    const int c = i % kCPR;
    const int pr = r0 + r;
    const bool ok = pr < nrows;
    const int qi = ok ? pr / p.G : 0;
    const int h = kvh * p.G + (ok ? pr % p.G : 0);
    cp_async16(Qs + r * kPitch + c * kChunk,
               static_cast<const T*>(p.q) +
                   ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * HD + c * kChunk,
               ok ? 16 : 0);
  }
  cp_async_commit();

  // 2. which tiles of [t_begin, t_end) can hold a key that a row sees
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int pr = r0 + tid; pr < min(r0 + kRows, nrows); pr += kThreads) {
    const int qp = q_position(pr);
    qlo = min(qlo, qp);
    qhi = max(qhi, qp);
  }
  int kfirst = INT_MAX;                              // smallest k_pos of the first tile
  if (tid < min(kTileK, p.Sk)) kfirst = k_position(tid);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qlo = min(qlo, __shfl_xor_sync(0xffffffffu, qlo, o));
    qhi = max(qhi, __shfl_xor_sync(0xffffffffu, qhi, o));
    kfirst = min(kfirst, __shfl_xor_sync(0xffffffffu, kfirst, o));
  }
  if (lane == 0) {
    red[3 * warp] = qlo;
    red[3 * warp + 1] = qhi;
    red[3 * warp + 2] = kfirst;
  }
  __syncthreads();
  qlo = INT_MAX;
  qhi = INT_MIN;
  int kmin = INT_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    qlo = min(qlo, red[3 * w]);
    qhi = max(qhi, red[3 * w + 1]);
    kmin = min(kmin, red[3 * w + 2]);
  }
  if (p.causal && qlo < kmin) {
    // some row may see no key of the first tile: the smallest k_pos of the batch row decides
    int km = INT_MAX;
#pragma unroll 8
    for (int j = kTileK + tid; j < p.Sk; j += kThreads) km = min(km, k_position(j));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) km = min(km, __shfl_xor_sync(0xffffffffu, km, o));
    if (lane == 0) red[3 * kWarps + warp] = km;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) kmin = min(kmin, red[3 * kWarps + w]);
  }
  // Skipping is exact only if every row of the block sees some key.  Each
  // tile gets two flags: kNeeded (some key a row of the block may see) and
  // kMasked (some key a row may not see, or past Sk); tiles without kMasked
  // skip the mask arithmetic.
  constexpr int kNeeded = 1, kMasked = 2;
  const bool skip = p.causal && qlo >= kmin;
  const int n_range = max(0, t_end - t_begin);
  for (int i = tid; i < n_range; i += kThreads) {
    tiles[i] = (skip ? 0 : kNeeded) | (p.causal && !skip ? kMasked : 0);
  }
  if (skip) {
    __syncthreads();                                 // flags cleared before any is set
    const int j_begin = t_begin * kTileK;
    const int j_end = min(t_end * kTileK, p.Sk);
    constexpr int kBatch = 8;                        // loads in flight per thread
    for (int base = j_begin; base < j_end; base += kBatch * kThreads) {
      int kp[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = base + u * kThreads + tid;
        kp[u] = j < j_end ? k_position(j) : INT_MAX;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        // a warp's 32 keys lie in one tile (j_begin is a tile boundary)
        const int j = base + u * kThreads + tid;
        const unsigned seen = __ballot_sync(0xffffffffu, j < j_end && kp[u] <= qhi);
        const unsigned hidden = __ballot_sync(0xffffffffu, j < j_end && kp[u] > qlo);
        if (lane == 0 && (seen | hidden) != 0u) {
          atomicOr(&tiles[(j - tid + warp * 32) / kTileK - t_begin],
                   (seen ? kNeeded : 0) | (hidden ? kMasked : 0));
        }
      }
    }
  }
  __syncthreads();
  if (warp == 0) {                                   // compact into a list of 2 t + masked, in place
    int cnt = 0;
    for (int base = 0; base < n_range; base += 32) {
      const int i = base + lane;
      const int f = i < n_range ? tiles[i] : 0;
      const unsigned bal = __ballot_sync(0xffffffffu, (f & kNeeded) != 0);
      if (f & kNeeded) {
        const int t = t_begin + i;
        const bool masked = (f & kMasked) || (t + 1) * kTileK > p.Sk;
        tiles[cnt + __popc(bal & ((1u << lane) - 1u))] = 2 * t + masked;
      }
      cnt += __popc(bal);
    }
    if (lane == 0) red[4 * kWarps] = cnt;
  }
  __syncthreads();
  const int n_tiles = red[4 * kWarps];

  // 3. this thread's rows (accumulator layout) and their q positions
  const int ra = wr * 16 + lane / 4;                 // rows ra and ra + 8 of the block
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pr = r0 + ra + 8 * i;
    qp[i] = pr < nrows ? q_position(pr) : 0;
  }

  auto load_tile = [&](int t, int stage) {
    T* ks = k_tile(stage);
    T* vs = v_tile(stage);
    for (int i = tid; i < kTileK * kCPR; i += kThreads) {
      const int jj = i / kCPR;
      const int c = i % kCPR;
      const int j = t * kTileK + jj;
      const bool ok = j < p.Sk;
      const long long off = static_cast<long long>(ok ? j : 0) * key_stride + c * kChunk;
      cp_async16(ks + jj * kPitch + c * kChunk, kb + off, ok ? 16 : 0);
      cp_async16(vs + jj * kPitch + c * kChunk, vb + off, ok ? 16 : 0);
    }
    if (kpos != nullptr && tid < kTileK) {
      const int j = t * kTileK + tid;
      cp_async4(KPs + stage * kTileK + tid, kpos + min(j, p.Sk - 1), j < p.Sk ? 4 : 0);
    }
  };

  float o[kDT][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  uint32_t qf[HD / 16][4];

  // kStages - 1 tiles ahead; every step commits one group (empty past the
  // last tile), so waiting for all but kStages - 1 groups means this tile
  constexpr int kStages = L::kStages;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(tiles[i] >> 1, i);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();                      // Q has landed
  __syncthreads();
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(qf[kk], Qs + (wr * 16 + lane % 16) * kPitch + kk * 16 + (lane / 16) * 8);
  }
  float* pw = reinterpret_cast<float*>(smem + L::p_off) + warp * 16 * L::kPPitch;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const int t = tiles[it] >> 1;
    const bool masked = tiles[it] & 1;
    const int ahead = it + kStages - 1;
    if (ahead < n_tiles) load_tile(tiles[ahead] >> 1, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();

    const T* ks = k_tile(stage) + wk * kKW * kPitch;
    const T* vs = v_tile(stage) + wk * kKW * kPitch;
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    scores<HD, kNT, kPitch>(s, qf, ks, Qs + wr * 16 * kPitch, lane);

    // scale, and mask a tile that holds a key some row may not see
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= p.scale;
    if (masked) {
      const int key0 = t * kTileK + wk * kKW + 2 * (lane % 4);
      const int* kp_tile = KPs + stage * kTileK + wk * kKW + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = key0 + n * 8 + (e & 1);
          if (j >= p.Sk) {
            s[n][e] = -__int_as_float(0x7f800000);   // -inf: an absent key weighs exactly 0
          } else if (p.causal && (kpos ? kp_tile[n * 8 + (e & 1)] : j) > qp[e >> 1]) {
            s[n][e] = kNegInf;
          }
        }
      }
    }

    // online softmax on the fragments; a row's 4 lanes form a quad
    float mx[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // differences first: NEG_INF * log2(e) would overflow to -inf, and -inf - -inf is NaN
      corr[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f((s[n][e] - m[e >> 1]) * kLog2e);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }
    accumulate<HD, kNT, kPitch, L::kPPitch>(o, s, vs, pw, lane);
    __syncthreads();                                 // this stage may be refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  if constexpr (WK > 1) {
    // merge the key-splitting warps of each row group (the K/V stages are free)
    constexpr int kR = L::kMergeRegs;
    float* mb = reinterpret_cast<float*>(smem + L::kv_off);
#pragma unroll
    for (int d = 0; d < kDT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) mb[(warp * kR + 4 * d + e) * 32 + lane] = o[d][e];
    mb[(warp * kR + 4 * kDT) * 32 + lane] = m[0];
    mb[(warp * kR + 4 * kDT + 1) * 32 + lane] = m[1];
    mb[(warp * kR + 4 * kDT + 2) * 32 + lane] = l[0];
    mb[(warp * kR + 4 * kDT + 3) * 32 + lane] = l[1];
    __syncthreads();
    if (wk != 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < WK; ++w) M = fmaxf(M, mb[((wr * WK + w) * kR + 4 * kDT + i) * 32 + lane]);
      float c[WK];
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w) {
        const int base = (wr * WK + w) * kR;
        c[w] = exp2f((mb[(base + 4 * kDT + i) * 32 + lane] - M) * kLog2e);
        lsum += mb[(base + 4 * kDT + 2 + i) * 32 + lane] * c[w];
      }
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          float acc = 0.f;
#pragma unroll
          for (int w = 0; w < WK; ++w) acc += mb[((wr * WK + w) * kR + 4 * d + e) * 32 + lane] * c[w];
          o[d][e] = acc;
        }
      }
      m[i] = M;
      l[i] = lsum;
    }
  }

  if (n_tiles == 0) {                                // an empty split weighs exactly 0 in the merge
    m[0] = m[1] = -__int_as_float(0x7f800000);
  }
  const long long bhs = static_cast<long long>(p.B) * p.H * p.Sq;
  const int c = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pr = r0 + ra + 8 * i;
    if (pr >= nrows) continue;
    const int qi = pr / p.G;
    const int h = kvh * p.G + pr % p.G;
    const long long row = (static_cast<long long>(b) * p.H + h) * p.Sq + qi;
    if (p.nsplit == 1) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* ob = static_cast<T*>(p.out) + ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * HD + c;
#pragma unroll
      for (int d = 0; d < kDT; ++d) store2(ob + d * 8, o[d][2 * i] / denom, o[d][2 * i + 1] / denom);
      if (p.m_out != nullptr && lane % 4 == 0) {
        p.m_out[row] = m[i];
        p.l_out[row] = l[i];
      }
    } else {
      const long long prow = split * bhs + row;
      float* po = p.part_o + prow * HD + c;
#pragma unroll
      for (int d = 0; d < kDT; ++d) store2(po + d * 8, o[d][2 * i], o[d][2 * i + 1]);
      if (lane % 4 == 0) {
        p.part_m[prow] = m[i];
        p.part_l[prow] = l[i];
      }
    }
  }
}

// Merges the key splits of each (b, h, q) row: one warp per row.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kMergeWarps) flash_fwd_split_merge(const Params p) {
  constexpr int kPer = (HD + 31) / 32;
  const long long bhs = static_cast<long long>(p.B) * p.H * p.Sq;
  const long long row = static_cast<long long>(blockIdx.x) * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= bhs) return;
  float M = -__int_as_float(0x7f800000);
  for (int s = 0; s < p.nsplit; ++s) M = fmaxf(M, p.part_m[s * bhs + row]);
  float lsum = 0.f;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int s = 0; s < p.nsplit; ++s) {
    const float w = exp2f((p.part_m[s * bhs + row] - M) * kLog2e);
    if (w == 0.f) continue;
    lsum += p.part_l[s * bhs + row] * w;
    const float* po = p.part_o + (s * bhs + row) * HD;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) acc[i] += po[d] * w;
    }
  }
  const int qi = static_cast<int>(row % p.Sq);
  const long long bh = row / p.Sq;
  const int h = static_cast<int>(bh % p.H);
  const long long b = bh / p.H;
  T* ob = static_cast<T*>(p.out) + ((b * p.Sq + qi) * p.H + h) * HD;
  const float denom = fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) ob[d] = from_f<T>(acc[i] / denom);
  }
  if (p.m_out != nullptr && lane == 0) {
    p.m_out[row] = M;
    p.l_out[row] = lsum;
  }
}

template <typename T, int HD, int WR, int WK>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<T, HD, WR, WK>;
  auto kernel = flash_fwd_kernel<T, HD, WR, WK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::total));
  if (err != cudaSuccess) return err;
  const int rows = p.G * p.Sq;
  const dim3 grid((rows + L::kRows - 1) / L::kRows, p.B * p.KV, p.nsplit);
  kernel<<<grid, 32 * L::kWarps, L::total, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  const long long bhs = static_cast<long long>(p.B) * p.H * p.Sq;
  flash_fwd_split_merge<T, HD><<<static_cast<unsigned>((bhs + kMergeWarps - 1) / kMergeWarps),
                                 32 * kMergeWarps, 0,
                                 stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_shape(const Params& p, int sms, cudaStream_t stream) {
  const int rows = p.G * p.Sq;
  if (rows <= 16) return launch<T, HD, 1, 4>(p, stream);   // decode: 16 rows, warps split keys
  // 64-row blocks, a warp per 16 rows; where they would leave SMs with fewer
  // than ~1.5 blocks, 8 warps instead of 4, two per 16 rows, each on half
  // of a tile's keys
  const long long blocks = static_cast<long long>((rows + 63) / 64) * p.B * p.KV * p.nsplit;
  if (2 * blocks < 3LL * sms) return launch<T, HD, 4, 2>(p, stream);
  return launch<T, HD, 4, 1>(p, stream);
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, int sms, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_shape<T, 32>(p, sms, stream);
    case 64: return dispatch_shape<T, 64>(p, sms, stream);
    case 112: return dispatch_shape<T, 112>(p, sms, stream);
    case 128: return dispatch_shape<T, 128>(p, sms, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  nsplit > 1 needs the partial buffers
// part_o (nsplit * B*H*Sq * hd fp32), part_m and part_l (nsplit * B*H*Sq).
// sms: the card's SM count, which picks the block shape.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, const void* qpos, const void* kpos,
    long long qpos_bstride, long long kpos_bstride, void* m_out, void* l_out, void* part_o,
    void* part_m, void* part_l, int B, int H, int KV, int Sq, int Sk, int hd, int causal,
    float scale, int nsplit, int sms, int dtype, void* stream) {
  cudaGetLastError();                                // report only this launch's error
  const int ntiles = Sk > 0 ? (Sk + kTileK - 1) / kTileK : 0;
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      (qpos == nullptr) != (kpos == nullptr) || (m_out == nullptr) != (l_out == nullptr) ||
      static_cast<long long>(B) * KV > 65535 || nsplit < 1 || nsplit > ntiles || nsplit > 65535 ||
      sms < 1 ||
      (nsplit > 1 && (part_o == nullptr || part_m == nullptr || part_l == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = (ntiles + nsplit - 1) / nsplit;
  if (per > kMaxTiles || (ntiles + per - 1) / per != nsplit) {
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
  p.part_o = static_cast<float*>(part_o);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.nsplit = nsplit;
  p.tiles_per_split = per;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch_hd<float>(p, hd, sms, s));
    case 1: return static_cast<int>(dispatch_hd<__nv_bfloat16>(p, hd, sms, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
