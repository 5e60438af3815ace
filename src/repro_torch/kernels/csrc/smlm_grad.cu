// SMLM weight gradient: the segmented outer-product reductions of the LoRA
// backward over a tile-aligned token stream,
//
//   dA[n] = sum_{t in n} X[t]^T Gs[t]      ([n, d_in, r])
//   dB[n] = sum_{t in n} S[t]^T dY[t]      ([n, r, d_out])
//
// over the tokens of tiles whose id is n and whose scale is nonzero, with
// S = scale * X A the forward's shrink and Gs = scale * dY B^T the shrink of
// the dX product (itself an SMLM call with B^T and A^T), both in the SMLM
// kernel's fp32 layout [tiles][groups][RP][8] (tokens past a tile's end 0).
// The Pallas package has no backward kernel (JAX differentiates its plain
// `lora_apply_ref`); this one is what the port's `SMLMFunction` runs on the
// card.
//
// Bound: bytes.  It reads X and dY of the live tokens once and both shrinks,
// and writes dA and dB, for 2 * T * r * (d_in + d_out) FLOPs: r FLOPs a
// byte read at r = 8.  So the kernel has to keep many 16-byte reads in
// flight on every SM, and spend few instructions on each of them.
//
// Design, one launch: grid (column chunks of COLS columns of d_in, then of
// d_out; bank slots), one block a (chunk, slot).  COLS is 128 up to RP = 8
// and 1024 / RP above, so that a warp's sums stay at 32 fp32 registers.
//  * Each block reads tile_ids / tile_scale once, coalesced, and lists its
//    slot's live tiles in order in shared memory (warp ballots plus a
//    prefix; WG_WINDOW tiles at a time).  A slot with no live tile writes
//    its zeros and leaves.
//  * The listed tiles' 8-token groups, two at a time, make K steps of 16
//    tokens, and warp w of the block takes K steps w, w + WG_WARPS, ...
//    Each warp streams its K steps through a ring of its own, WG_STAGES
//    stages of [16 tokens x COLS columns] of X (dA) or dY (dB) with the 16
//    tokens' fp32 shrink [2][RP][8] beside them, by 16-byte `cp.async`
//    copies (COLS / 16 a lane a K step, at constant offsets), synchronised
//    by `__syncwarp` alone, so the next stages are in flight while one is
//    summed.  Rows past a tile's end and
//    an odd last group are zero-filled.
//  * bf16: `mma.sync.m16n8k16` with the columns on M (the staged tile read
//    by `ldmatrix.trans`), the rank on N (RP / 8 n-tiles; ranks past RP = 4
//    zero) and the 16 tokens on K; the shrink is rounded to bf16 as it
//    becomes the B fragment, the sums are fp32.  fp32 (the reduced-size
//    parity runs and the full-width fp32 grad check only, whose 1e-4 gates
//    tf32 would miss): CUDA-core FMAs, a lane COLS / 32 columns.
//  * After the walk each warp writes its sums into the ring's bytes in the
//    output's layout ([COLS][RP] for dA, [RP][COLS + 4] for dB); the block
//    sums its warps in warp order.  A thread writes 8 outputs (one 16-byte
//    store in bf16 where the width, the rank and the alignment allow; else
//    masked scalars).  A warp with no K step adds zeros.  No workspace, no
//    memset, no atomics: two runs give the same bits.
// In bf16 a width that is not a multiple of 8 or an input off a 16-byte
// boundary takes element copies on that side, masked at the edge (as SMLM
// and BGMV do); fp32 copies 16 bytes where its width is a multiple of 4.
// The kernel reads no shrink of a dead tile.  Forms that measured slower
// (`PERF.md` section 6): one block of 128 columns walking a slot's tokens
// serially; eight warps splitting the whole tile stream, one or two
// columns a lane, sums on the CUDA cores; clusters of 2-8 blocks of 128
// columns splitting a slot's tiles, each warp 32 columns of every K step
// through one ring of the block, synchronised by the block: one 16-byte
// copy a thread a group, so the walk was bound by the instructions around
// each copy, and each doubling of the cluster cost more in its barriers;
// this kernel with its slot's tiles split over clusters of 2 or 4 blocks
// (slower at three of the four projection shapes of a grad step); and this
// kernel with its bf16 sums on the CUDA cores.
#include <type_traits>

#include "tile_walk.cuh"

namespace {

constexpr int WG_WARPS = 4;
constexpr int WG_THREADS = WG_WARPS * 32;
constexpr int WG_STAGES = 4;       // K steps of 16 tokens in a warp's ring
constexpr int WG_WINDOW = 1024;    // tiles listed at a time

// which sides move as 16-byte vectors (bit flags of the launch)
enum { VEC_X = 1, VEC_DY = 2, VEC_SHRINK = 4, VST_A = 8, VST_B = 16 };

// Shape of a block at rank pad RP: COLS columns; each warp's ring of
// WG_STAGES stages, a stage the 16 tokens' fp32 shrink [2][RP][8] then their
// rows [16][LDX] (padded by 16 bytes, so `ldmatrix` reads are free of bank
// conflicts); after the walk, in the same bytes, each warp's fp32 sums
// [PW] in the output's layout.
template <typename T, int RP>
struct Wg {
  static constexpr int COLS = RP <= 8 ? 128 : 1024 / RP;
  static constexpr int MT = COLS / 16;            // m16 tiles (bf16)
  static constexpr int NT = RP < 8 ? 1 : RP / 8;  // n8 tiles (bf16)
  static constexpr int CPL = COLS >= 32 ? COLS / 32 : 1;   // fp32 columns
  static constexpr int LPC = COLS >= 32 ? 1 : 32 / COLS;   // fp32 lanes a
  static constexpr int RPL = RP / LPC;                     // column; ranks
  static constexpr int VE = 16 / sizeof(T);       // elements a vector
  static constexpr int CV = COLS / VE;            // vectors a row
  static constexpr int LDX = COLS + VE;
  static constexpr int SH = 2 * RP * 8;           // shrink floats a stage
  static constexpr size_t STAGE = SH * sizeof(float) + 16 * LDX * sizeof(T);
  static constexpr size_t RING = WG_STAGES * STAGE;   // a warp's
  static constexpr int LDB = COLS + 4;            // a dB sum row
  static constexpr int PW = RP * LDB;             // a warp's sums, floats
  // floats between two warps' bytes
  static constexpr int WSTRIDE = RING / sizeof(float) > PW
                                     ? static_cast<int>(RING / sizeof(float))
                                     : PW;
  static constexpr size_t BYTES = WG_WARPS * WSTRIDE * sizeof(float);
};

template <typename T, int RP>
__global__ void __launch_bounds__(WG_THREADS)
smlm_wgrad(const T* __restrict__ x, const T* __restrict__ dy,
           const float* __restrict__ s, const float* __restrict__ gs,
           const int* __restrict__ tile_ids,
           const float* __restrict__ tile_scale, T* __restrict__ da,
           T* __restrict__ db, int T_, int n, int d_in, int r, int d_out,
           int block_t, unsigned flags) {
  using L = Wg<T, RP>;
  constexpr int COLS = L::COLS;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int list[WG_WINDOW];
  __shared__ int wcnt[WG_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, slot = blockIdx.y;
  const int n_a = (d_in + COLS - 1) / COLS;
  const bool is_a = chunk < n_a;
  const int c0 = (is_a ? chunk : chunk - n_a) * COLS;
  const int width = is_a ? d_in : d_out;
  const T* src = is_a ? x : dy;
  const float* shrink = is_a ? gs : s;
  const bool vin = flags & (is_a ? VEC_X : VEC_DY);
  const bool vsh = flags & VEC_SHRINK;
  const bool vout = flags & (is_a ? VST_A : VST_B);
  const int tiles = T_ / block_t, G = (block_t + 7) / 8;
  auto live = [&](int tile) {
    int id = tile_ids[tile];
    id = id < 0 ? 0 : (id >= n ? n - 1 : id);
    return id == slot && tile_scale[tile] != 0.f;
  };
  // the slot's live tiles of [w0, w0 + WG_WINDOW) into list, in order;
  // returns their count (every thread calls it; it synchronises)
  auto list_window = [&](int w0) {
    const int w1 = min(tiles, w0 + WG_WINDOW);
    int cnt = 0;
    for (int c = w0; c < w1; c += WG_THREADS) {
      const bool lv = c + tid < w1 && live(c + tid);
      const unsigned bal = __ballot_sync(repro::FULL_MASK, lv);
      if (lane == 0) wcnt[warp] = __popc(bal);
      __syncthreads();
      int at = cnt;
#pragma unroll
      for (int w = 0; w < WG_WARPS; ++w) {
        at += w < warp ? wcnt[w] : 0;
        cnt += wcnt[w];
      }
      if (lv) list[at + __popc(bal & ((1u << lane) - 1u))] = c + tid;
      __syncthreads();   // wcnt is the next chunk's
    }
    return cnt;
  };

  int cnt = list_window(0);
  int total = cnt;
  for (int c = WG_WINDOW; c < tiles; c += WG_THREADS)
    total += __syncthreads_count(c + tid < tiles && live(c + tid));
  if (total == 0) {
    const int nc = min(COLS, width - c0);
    for (int e = tid; e < nc * r; e += WG_THREADS) {
      if (is_a) {
        da[(static_cast<size_t>(slot) * d_in + c0) * r + e] =
            repro::from_f<T>(0.f);
      } else {
        const int k = e / nc, c = e - k * nc;
        db[(static_cast<size_t>(slot) * r + k) * d_out + c0 + c] =
            repro::from_f<T>(0.f);
      }
    }
    return;
  }

  unsigned char* ring = smem + warp * L::WSTRIDE * sizeof(float);
  float acc[BF16 ? L::MT : 1][BF16 ? L::NT : 1][4] = {};   // bf16
  float facc[BF16 ? 1 : L::CPL][BF16 ? 1 : L::RPL] = {};     // fp32
  for (int w0 = 0;;) {
    const int groups = cnt * G, ksteps = (groups + 1) / 2;
    const int my_ks =
        ksteps > warp ? (ksteps - warp + WG_WARPS - 1) / WG_WARPS : 0;
    // this warp's j-th K step (groups 2 ks and 2 ks + 1 of the window's, ks =
    // warp + j WG_WARPS) into stage st of its ring
    auto stage = [&](int j, int st) {
      float* sh = reinterpret_cast<float*>(ring + st * L::STAGE);
      T* xs = reinterpret_cast<T*>(sh + L::SH);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 2 * (warp + j * WG_WARPS) + h;
        const bool real = q < groups;   // else the odd group's zero pad
        int nt = 0;
        const T* rows = src;
        const float* sg = shrink;
        if (real) {
          const int i = G == 1 ? q : q / G, g = G == 1 ? 0 : q - i * G;
          const int tile = list[i];
          nt = min(8, block_t - g * 8);
          rows = src + (static_cast<size_t>(tile) * block_t + g * 8) * width +
                 c0;
          sg = shrink + (static_cast<size_t>(tile) * G + g) * RP * 8;
        }
        float* shh = sh + h * RP * 8;
        if (vsh) {
#pragma unroll
          for (int e = lane; e < RP * 2; e += 32)
            repro::cp_async16(shh + e * 4, real ? sg + e * 4 : shrink, real);
        } else {
          for (int e = lane; e < RP * 8; e += 32)
            shh[e] = real ? sg[e] : 0.f;
        }
        T* xh = xs + h * 8 * L::LDX;
        if (vin) {
#pragma unroll
          for (int e = lane; e < 8 * L::CV; e += 32) {
            const int i = e / L::CV, col = (e - i * L::CV) * L::VE;
            const bool ok = i < nt && c0 + col < width;
            repro::cp_async16(xh + i * L::LDX + col,
                              ok ? rows + static_cast<size_t>(i) * width + col
                                 : src,
                              ok);
          }
        } else {
          for (int e = lane; e < 8 * COLS; e += 32) {
            const int i = e / COLS, col = e - i * COLS;
            xh[i * L::LDX + col] =
                i < nt && c0 + col < width
                    ? rows[static_cast<size_t>(i) * width + col]
                    : repro::from_f<T>(0.f);
          }
        }
      }
    };
#pragma unroll 1
    for (int p = 0; p < WG_STAGES - 1; ++p) {
      if (p < my_ks) stage(p, p);
      repro::cp_async_commit();
    }
    for (int j = 0; j < my_ks; ++j) {
      repro::cp_async_wait<WG_STAGES - 2>();   // K step j has landed
      __syncwarp();   // ... for every lane; stage j - 1 is free
      if (j + WG_STAGES - 1 < my_ks)
        stage(j + WG_STAGES - 1, (j + WG_STAGES - 1) % WG_STAGES);
      repro::cp_async_commit();
      const float* sh =
          reinterpret_cast<const float*>(ring + (j % WG_STAGES) * L::STAGE);
      const T* xs = reinterpret_cast<const T*>(sh + L::SH);
      if constexpr (BF16) {
        unsigned b[L::NT][2];   // the shrink [16 tokens x 8 ranks], bf16
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt) {
          const int k = nt * 8 + (lane >> 2), t2 = 2 * (lane & 3);
          if (RP >= 8 || k < RP) {
            const float2 u = *reinterpret_cast<const float2*>(sh + k * 8 + t2);
            const float2 v =
                *reinterpret_cast<const float2*>(sh + (RP + k) * 8 + t2);
            b[nt][0] = repro::pack_bf16(u.x, u.y);
            b[nt][1] = repro::pack_bf16(v.x, v.y);
          } else {
            b[nt][0] = b[nt][1] = 0u;
          }
        }
        const int q = lane >> 3;
        const T* xa =
            xs + ((lane & 7) + ((q >> 1) << 3)) * L::LDX + (q & 1) * 8;
#pragma unroll
        for (int mt = 0; mt < L::MT; ++mt) {
          unsigned a[4];   // the rows transposed: [16 columns x 16 tokens]
          repro::ldsm_x4_t(xa + mt * 16, a[0], a[1], a[2], a[3]);
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt)
            repro::mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
      } else {
        const int col = L::LPC == 1 ? lane : lane % COLS;
        const int k0 = L::LPC == 1 ? 0 : (lane / COLS) * L::RPL;
#pragma unroll 4
        for (int i = 0; i < 16; ++i) {
          const float* si = sh + (i >> 3) * RP * 8 + (i & 7);
#pragma unroll
          for (int c = 0; c < L::CPL; ++c) {
            const float xv = xs[i * L::LDX + col + 32 * c];
#pragma unroll
            for (int k = 0; k < L::RPL; ++k)
              facc[c][k] = fmaf(xv, si[(k0 + k) * 8], facc[c][k]);
          }
        }
      }
    }
    repro::cp_async_wait<0>();
    w0 += WG_WINDOW;
    if (w0 >= tiles) break;
    __syncthreads();   // every stage is summed: the list is the next's
    cnt = list_window(w0);
  }

  // each warp's sums into its own bytes, in the output's layout
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  float* sums = part + warp * L::WSTRIDE;
  if constexpr (BF16) {
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        // acc: columns col (+8), ranks k, k + 1
        const int col = mt * 16 + (lane >> 2), k = nt * 8 + 2 * (lane & 3);
        if (RP < 8 && k >= RP) continue;
        const float* c = acc[mt][nt];
        if (is_a) {
          *reinterpret_cast<float2*>(sums + col * RP + k) =
              make_float2(c[0], c[1]);
          *reinterpret_cast<float2*>(sums + (col + 8) * RP + k) =
              make_float2(c[2], c[3]);
        } else {
          sums[k * L::LDB + col] = c[0];
          sums[(k + 1) * L::LDB + col] = c[1];
          sums[k * L::LDB + col + 8] = c[2];
          sums[(k + 1) * L::LDB + col + 8] = c[3];
        }
      }
    }
  } else {
    const int col = L::LPC == 1 ? lane : lane % COLS;
    const int k0 = L::LPC == 1 ? 0 : (lane / COLS) * L::RPL;
#pragma unroll
    for (int c = 0; c < L::CPL; ++c)
#pragma unroll
      for (int k = 0; k < L::RPL; ++k) {
        if (is_a)
          sums[(col + 32 * c) * RP + k0 + k] = facc[c][k];
        else
          sums[(k0 + k) * L::LDB + col + 32 * c] = facc[c][k];
      }
  }
  __syncthreads();

  // an item: 8 consecutive sums of the layout (dA: min(8, RP) ranks of a
  // column; dB: 8 columns of a rank), written to dA or dB
  constexpr int VK = RP < 8 ? RP : 8;
  constexpr int KI = RP / VK;   // dA items a column
  constexpr int CI = COLS / 8;  // dB items a rank
  const int items = is_a ? COLS * KI : r * CI;
  auto offset = [&](int e) {
    return is_a ? (e / KI) * RP + (e % KI) * VK
                : (e / CI) * L::LDB + (e % CI) * 8;
  };
  auto add8 = [&](const float* p, float (&v)[8]) {
    const float4 lo = reinterpret_cast<const float4*>(p)[0];
    v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
    if (!is_a || RP >= 8) {
      const float4 hi = reinterpret_cast<const float4*>(p)[1];
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
  };
  auto put = [&](int e, const float (&v)[8]) {
    if (is_a) {
      const int col = e / KI, k0 = (e % KI) * VK;
      if (c0 + col >= width) return;
      T* o = da + (static_cast<size_t>(slot) * d_in + c0 + col) * r + k0;
      if constexpr (BF16) {
        if (vout) {   // r == RP >= 8: 8 ranks, one 16-byte store
          uint4 w;
          w.x = repro::pack_bf16(v[0], v[1]);
          w.y = repro::pack_bf16(v[2], v[3]);
          w.z = repro::pack_bf16(v[4], v[5]);
          w.w = repro::pack_bf16(v[6], v[7]);
          *reinterpret_cast<uint4*>(o) = w;
          return;
        }
      }
#pragma unroll
      for (int i = 0; i < VK; ++i)
        if (k0 + i < r) o[i] = repro::from_f<T>(v[i]);
    } else {
      const int k = e / CI, cc = (e % CI) * 8;
      if (c0 + cc >= width) return;
      T* o = db + (static_cast<size_t>(slot) * r + k) * d_out + c0 + cc;
      if constexpr (BF16) {
        if (vout) {   // d_out % 8 == 0: 8 columns, one 16-byte store
          uint4 w;
          w.x = repro::pack_bf16(v[0], v[1]);
          w.y = repro::pack_bf16(v[2], v[3]);
          w.z = repro::pack_bf16(v[4], v[5]);
          w.w = repro::pack_bf16(v[6], v[7]);
          *reinterpret_cast<uint4*>(o) = w;
          return;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c0 + cc + i < width) o[i] = repro::from_f<T>(v[i]);
    }
  };
  // the block's sum of its warps, in warp order
  for (int e = tid; e < items; e += WG_THREADS) {
    const int off = offset(e);
    float v[8] = {};
#pragma unroll
    for (int w = 0; w < WG_WARPS; ++w) add8(part + w * L::WSTRIDE + off, v);
    put(e, v);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

struct Args {
  const void *x, *dy;
  const float *s, *gs;
  const int* ids;
  const float* scale;
  void *da, *db;
  int T_, n, d_in, r, d_out, block_t;
  cudaStream_t st;
};

template <typename T, int RP>
cudaError_t launch_rp(const Args& a) {
  using L = Wg<T, RP>;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  unsigned flags = 0;
  if (a.d_in % L::VE == 0 && aligned16(a.x)) flags |= VEC_X;
  if (a.d_out % L::VE == 0 && aligned16(a.dy)) flags |= VEC_DY;
  if (aligned16(a.s) && aligned16(a.gs)) flags |= VEC_SHRINK;
  if (BF16 && a.r == RP && RP >= 8 && aligned16(a.da)) flags |= VST_A;
  if (BF16 && a.d_out % 8 == 0 && aligned16(a.db)) flags |= VST_B;
  const int chunks =
      (a.d_in + L::COLS - 1) / L::COLS + (a.d_out + L::COLS - 1) / L::COLS;
  auto kern = smlm_wgrad<T, RP>;
  cudaError_t e = repro::allow_smem(kern, L::BYTES);
  if (e != cudaSuccess) return e;
  kern<<<dim3(chunks, a.n), WG_THREADS, L::BYTES, a.st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.s, a.gs,
      a.ids, a.scale, static_cast<T*>(a.da), static_cast<T*>(a.db), a.T_,
      a.n, a.d_in, a.r, a.d_out, a.block_t, flags);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Args& a) {
  if (a.r <= 4) return launch_rp<T, 4>(a);
  if (a.r <= 8) return launch_rp<T, 8>(a);
  if (a.r <= 16) return launch_rp<T, 16>(a);
  if (a.r <= 32) return launch_rp<T, 32>(a);
  if (a.r <= 64) return launch_rp<T, 64>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: [T, d_in], dy: [T, d_out] (one dtype); s, gs: fp32 shrink buffers of
// the SMLM layout covering the T tokens' tiles; tile_ids, tile_scale: [T /
// block_t]; da: [n, d_in, r], db: [n, r, d_out] in x's dtype, every element
// written.
extern "C" int smlm_wgrad_launch(const void* x, const void* dy, const void* s,
                                 const void* gs, const void* tile_ids,
                                 const void* tile_scale, void* da, void* db,
                                 int T_, int n, int d_in, int r, int d_out,
                                 int block_t, int dtype, void* stream) {
  if (n <= 0 || d_in <= 0 || d_out <= 0) return 0;
  if (T_ < 0 || block_t <= 0 || T_ % block_t != 0 || r <= 0 || n > 65535)
    return cudaErrorInvalidValue;
  const Args a{x, dy, static_cast<const float*>(s),
               static_cast<const float*>(gs),
               static_cast<const int*>(tile_ids),
               static_cast<const float*>(tile_scale), da, db, T_, n, d_in, r,
               d_out, block_t, static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float>(a);
  else if (dtype == DT_BF16)
    e = launch_t<__nv_bfloat16>(a);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
