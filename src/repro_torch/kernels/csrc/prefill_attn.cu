// Paged prefill attention: suffix-only prefill over a block-table KV pool.
//
// Port of the Pallas kernel repro/kernels/prefill_attn.py:78
// (`paged_prefill_attention`, body :34).  Request b contributes Sq suffix
// queries at absolute positions cached[b] + i; its keys (shared prefix and
// this suffix, both already written to the pool) are valid for
// j < cached[b] + seg[b], and causal by absolute position (j <= q position).
//
// One block per (request, query tile, KV head): the tile is bq = 64 / m
// query positions times the m = h/g query heads of the group, 64 query rows
// in all, 8 per warp.  Each K/V block of the table is read once per tile and
// staged in shared memory as fp32 with a padded row; lane j scores key j of
// a 32-key chunk against the warp's rows, and the online softmax stays in
// fp32 registers (each lane owns hd/32 output dims of each row).  The walk
// stops at the last block that the causal and valid limits allow.  Rows with
// no valid key (seg == 0 padding rows) finalize to 0.
#include "common.cuh"

namespace {

constexpr int PF_WARPS = 8;
constexpr int PF_ROWS = 64;                   // query rows per block
constexpr int PF_RPW = PF_ROWS / PF_WARPS;    // rows per warp
constexpr int MAX_NI = 8;                     // hd <= 256

template <typename T>
__global__ void __launch_bounds__(PF_WARPS * 32)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ tables,
                     const int* __restrict__ cached,
                     const int* __restrict__ seg, T* __restrict__ out, int Sq,
                     int h, int g, int hd, int bs, int nbt, int bq,
                     float scale) {
  extern __shared__ float sm[];
  const int ldk = hd + 1;
  float* Ks = sm;                  // [bs][hd + 1]
  float* Vs = Ks + bs * ldk;       // [bs][hd + 1]
  float* Qs = Vs + bs * ldk;       // [PF_ROWS][hd]
  const int b = blockIdx.x;
  const int iq = blockIdx.y;
  const int kvh = blockIdx.z;
  const int m = h / g;
  const int rows = bq * m;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ni = hd / 32;
  const int c0 = cached[b];
  const int kend = c0 + seg[b];    // keys j < kend are written

  // stage the tile's queries: row rr = qi * m + qh
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int rr = i / hd, d = i - rr * hd;
    const int qi = rr / m, qh = rr - qi * m;
    const int si = iq * bq + qi;
    Qs[i] = si < Sq ? repro::to_f(q[((static_cast<size_t>(b) * Sq + si) * h +
                                      kvh * m + qh) * hd + d])
                    : 0.f;
  }
  const int qpos_max = c0 + min((iq + 1) * bq, Sq) - 1;
  const int klimit = min(kend, qpos_max + 1);
  const int nblk = klimit <= 0 ? 0 : min(nbt, (klimit + bs - 1) / bs);

  float acc[PF_RPW][MAX_NI];
  float m_run[PF_RPW], l_run[PF_RPW];
  int qpos[PF_RPW];
#pragma unroll
  for (int r = 0; r < PF_RPW; ++r) {
    m_run[r] = repro::NEG_INF;
    l_run[r] = 0.f;
    const int rr = warp + PF_WARPS * r;
    qpos[r] = c0 + iq * bq + rr / m;
#pragma unroll
    for (int i = 0; i < MAX_NI; ++i) acc[r][i] = 0.f;
  }

  for (int ib = 0; ib < nblk; ++ib) {
    int bid = tables[static_cast<size_t>(b) * nbt + ib];
    bid = bid < 0 ? 0 : bid;
    __syncthreads();  // previous block's reads (and the Q staging) are done
    for (int i = threadIdx.x; i < bs * hd; i += blockDim.x) {
      const int j = i / hd, d = i - j * hd;
      const size_t off =
          ((static_cast<size_t>(bid) * bs + j) * g + kvh) * hd + d;
      Ks[j * ldk + d] = repro::to_f(kp[off]);
      Vs[j * ldk + d] = repro::to_f(vp[off]);
    }
    __syncthreads();
    for (int c = 0; c < bs; c += 32) {
      const int j = c + lane;
      const int jpos = ib * bs + j;
      float s[PF_RPW];
#pragma unroll
      for (int r = 0; r < PF_RPW; ++r) s[r] = 0.f;
      if (j < bs) {
        const float* kr = Ks + j * ldk;
        for (int d = 0; d < hd; ++d) {
          const float kv = kr[d];
#pragma unroll
          for (int r = 0; r < PF_RPW; ++r)
            s[r] += Qs[(warp + PF_WARPS * r) * hd + d] * kv;
        }
      }
      float pr[PF_RPW];
#pragma unroll
      for (int r = 0; r < PF_RPW; ++r) {
        pr[r] = 0.f;
        if (warp + PF_WARPS * r >= rows) continue;   // warp-uniform
        const bool valid = j < bs && jpos <= qpos[r] && jpos < kend;
        const float sv = valid ? s[r] * scale : repro::NEG_INF;
        const float m_new = fmaxf(m_run[r], repro::warp_max(sv));
        pr[r] = valid ? expf(sv - m_new) : 0.f;
        const float corr = expf(fminf(m_run[r] - m_new, 0.f));
        l_run[r] = l_run[r] * corr + repro::warp_sum(pr[r]);
#pragma unroll
        for (int i = 0; i < MAX_NI; ++i) acc[r][i] *= corr;
        m_run[r] = m_new;
      }
      const int nj = min(32, bs - c);
      for (int jj = 0; jj < nj; ++jj) {
        const float* vr = Vs + (c + jj) * ldk + lane;
        float pv[PF_RPW];
#pragma unroll
        for (int r = 0; r < PF_RPW; ++r)
          pv[r] = __shfl_sync(repro::FULL_MASK, pr[r], jj);
#pragma unroll
        for (int i = 0; i < MAX_NI; ++i) {
          if (i < ni) {
            const float v = vr[32 * i];
#pragma unroll
            for (int r = 0; r < PF_RPW; ++r) acc[r][i] += pv[r] * v;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < PF_RPW; ++r) {
    const int rr = warp + PF_WARPS * r;
    if (rr >= rows) continue;
    const int qi = rr / m, qh = rr - qi * m;
    const int si = iq * bq + qi;
    if (si >= Sq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    T* ob = out + ((static_cast<size_t>(b) * Sq + si) * h + kvh * m + qh) *
                      hd + lane;
#pragma unroll
    for (int i = 0; i < MAX_NI; ++i)
      if (i < ni) ob[32 * i] = repro::from_f<T>(acc[r][i] / l);
  }
}

template <typename T>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const int* tables, const int* cached, const int* seg,
                     void* out, int B, int Sq, int h, int g, int hd, int bs,
                     int nbt, float scale, cudaStream_t stream) {
  const int m = h / g;
  const int bq = PF_ROWS / m;
  const size_t smem = (2 * static_cast<size_t>(bs) * (hd + 1) +
                       static_cast<size_t>(PF_ROWS) * hd) * sizeof(float);
  cudaError_t e = repro::allow_smem(paged_prefill_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, (Sq + bq - 1) / bq, g);
  paged_prefill_kernel<T><<<grid, PF_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, cached, seg, static_cast<T*>(out),
      Sq, h, g, hd, bs, nbt, bq, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_prefill_launch(const void* q, const void* k_pool,
                                    const void* v_pool, const void* tables,
                                    const void* cached, const void* seg,
                                    void* out, int B, int Sq, int h, int g,
                                    int hd, int bs, int nbt, float scale,
                                    int dtype, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (g <= 0 || h % g != 0 || PF_ROWS % (h / g) != 0 || hd % 32 != 0 ||
      hd > 32 * MAX_NI || bs <= 0 || nbt <= 0 || g > 65535)
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(cached);
  const int* sl = static_cast<const int*>(seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float>(q, k_pool, v_pool, tb, cl, sl, out, B, Sq, h, g, hd, bs, nbt, scale, s);
  else if (dtype == DT_BF16)
    e = launch_t<__nv_bfloat16>(q, k_pool, v_pool, tb, cl, sl, out, B, Sq, h, g, hd, bs, nbt, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
