// Banded affine-gap seed extension (ksw_extend) for NVIDIA Hopper,
// called from JAX through the FFI (kernels/sw_cuda.py builds and binds it).
//
// One thread per extension lane runs the scalar row loop of
// cpu/ksw.py's ksw_extend: Z-drop, the adaptive beg/end band and the
// to-query-end (gscore) bookkeeping. A lane leaves the loop as soon as
// its own DP ends, so the slowest lane no longer keeps the whole batch
// iterating, as kernels/sw.py's batch-global while_loop does. The
// caller sorts lanes by expected work so that a warp's lanes end
// together.
//
// Results equal kernels/sw.py:sw_extend_batch exactly, including that
// kernel's conventions where they differ from the scalar loop: row-max
// ties go to the largest column, DP cells outside [beg, end] read as
// zero, and a cell at column max_qlen does not exist.
//
// Layouts are lane-minor, so a warp at one column touches one
// contiguous segment:
//   query_t  uint8 (Q, B)    codes 0..4 score by mat; 5 scores 0
//   target_t uint8 (T, B)    codes 0..4
//   eh       int32 (Q+2, B, 2) scratch: H(i-1, j-1), E(i, j) per column
//   out      int32 (6, B)    score, qle, tle, gtle, gscore, max_off

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 64;
constexpr int kCodes = 6;  // 0..4 and the "scores 0" code 5

struct Params {
  int o_del, e_del, o_ins, e_ins, end_bonus, zdrop, max_sc;
  int mat[5 * kCodes];  // mat[t * kCodes + q]
};

__device__ __forceinline__ bool live(int2 c) { return (c.x | c.y) != 0; }

__global__ void __launch_bounds__(kThreads)
sw_extend_kernel(const uint8_t* __restrict__ query_t,
                 const int32_t* __restrict__ qlen_a,
                 const uint8_t* __restrict__ target_t,
                 const int32_t* __restrict__ tlen_a,
                 const int32_t* __restrict__ w_a,
                 const int32_t* __restrict__ h0_a,
                 int B, int Q, int T, Params p,
                 int32_t* __restrict__ out, int2* __restrict__ eh) {
  __shared__ int smat[5 * kCodes];
  for (int k = threadIdx.x; k < 5 * kCodes; k += blockDim.x) smat[k] = p.mat[k];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  // qlen <= Q and tlen <= T are the caller's contract; clamping keeps a
  // violation inside the scratch buffer
  const int qlen = min(qlen_a[lane], Q), tlen = min(tlen_a[lane], T);
  const int h0 = h0_a[lane];
  const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;

  // ksw_extend's band clamp, in float32 like the XLA kernel
  const int max_ins = static_cast<int>(
      static_cast<float>(qlen * p.max_sc + p.end_bonus - p.o_ins) /
          static_cast<float>(p.e_ins) + 1.0f);
  const int max_del = static_cast<int>(
      static_cast<float>(qlen * p.max_sc + p.end_bonus - p.o_del) /
          static_cast<float>(p.e_del) + 1.0f);
  int w = min(w_a[lane], max(max_ins, 1));
  w = min(w, max(max_del, 1));

  int2* col = eh + lane;  // column j of this lane is col[j * B]
  const size_t stride = static_cast<size_t>(B);

  int score = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  if (tlen > 0 && qlen > 0) {
    // first H row: h0, then h0 - oe_ins - e_ins * (j - 1) while positive
    const int n_init = min(qlen + 1, Q);
    for (int j = 0; j < n_init; ++j) {
      const int h = j == 0 ? h0 : h0 - oe_ins - p.e_ins * (j - 1);
      col[j * stride] = make_int2(h > 0 ? h : 0, 0);
    }
    int beg = 0, end = qlen;
    for (int i = 0;; ++i) {
      beg = max(beg, i - w);
      end = min(min(end, i + w + 1), qlen);
      const int* srow = smat + min(int(target_t[i * stride + lane]), 4) * kCodes;
      const int h1_bound =
          beg == 0 ? max(h0 - (p.o_del + p.e_del * (i + 1)), 0) : 0;
      int h1 = h1_bound, f = 0, row_max = -1, row_j = -1;
      for (int j = beg; j < end; ++j) {
        // col[j] holds H(i-1, j-1) and E(i, j); leave H(i, j-1), E(i+1, j)
        const int2 c = col[j * stride];
        const int s = srow[query_t[j * stride + lane]];
        const int m = c.x ? c.x + s : 0;
        const int h = max(max(m, c.y), f);
        col[j * stride] = make_int2(h1, max(c.y - p.e_del, max(m - oe_del, 0)));
        h1 = h;
        if (h >= row_max) {
          row_max = h;
          row_j = j;
        }
        f = max(f - p.e_ins, max(m - oe_ins, 0));
      }
      // H(i, end-1) at column end; the column past it reads as zero
      col[end * stride] = make_int2(end < Q ? h1 : 0, 0);
      if (end + 1 <= qlen) col[(end + 1) * stride] = make_int2(0, 0);

      if (end == qlen && gscore <= h1) {
        gscore = h1;
        max_ie = i;
      }
      const int m_best = max(row_max, 0);
      const int mj = m_best > 0 ? row_j : -1;
      const bool improved = m_best > score;
      const int di = i - max_i, dj = mj - max_j;
      const bool zd = di > dj
                          ? score - m_best - (di - dj) * p.e_del > p.zdrop
                          : score - m_best - (dj - di) * p.e_ins > p.zdrop;
      const bool break_z = !improved && p.zdrop > 0 && zd;
      if (improved) {
        max_off = max(max_off, abs(mj - i));
        score = m_best;
        max_i = i;
        max_j = mj;
      }
      if (m_best == 0 || break_z || i + 1 >= tlen) break;

      // shrink the band to live cells of [beg, end]
      int first = -1;
      for (int j = beg; j <= end; ++j)
        if (live(col[j * stride])) {
          first = j;
          break;
        }
      if (first < 0) {
        const int old_end = end;
        end = min(beg + 1, qlen);
        beg = old_end;
      } else {
        int last = end;
        while (!live(col[last * stride])) --last;
        beg = first;
        end = min(last + 2, qlen);
      }
    }
  }
  out[0 * stride + lane] = score;
  out[1 * stride + lane] = max_j + 1;
  out[2 * stride + lane] = max_i + 1;
  out[3 * stride + lane] = max_ie + 1;
  out[4 * stride + lane] = gscore;
  out[5 * stride + lane] = max_off;
}

ffi::Error SwExtendImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> query_t,
                        ffi::Buffer<ffi::S32> qlen, ffi::Buffer<ffi::U8> target_t,
                        ffi::Buffer<ffi::S32> tlen, ffi::Buffer<ffi::S32> w,
                        ffi::Buffer<ffi::S32> h0,
                        ffi::ResultBuffer<ffi::S32> out,
                        ffi::ResultBuffer<ffi::S32> scratch,
                        ffi::Span<const int32_t> mat, int32_t o_del,
                        int32_t e_del, int32_t o_ins, int32_t e_ins,
                        int32_t end_bonus, int32_t zdrop) {
  const auto qd = query_t.dimensions();
  const auto td = target_t.dimensions();
  if (qd.size() != 2 || td.size() != 2 || mat.size() != 25)
    return ffi::Error::InvalidArgument("sw_extend: bad operand ranks");
  const int Q = static_cast<int>(qd[0]), B = static_cast<int>(qd[1]);
  const int T = static_cast<int>(td[0]);
  if (td[1] != B || qlen.element_count() != static_cast<size_t>(B) ||
      scratch->element_count() != static_cast<size_t>(Q + 2) * B * 2)
    return ffi::Error::InvalidArgument("sw_extend: operand shapes disagree");
  if (B == 0) return ffi::Error::Success();
  if (T == 0 || Q == 0)
    return ffi::Error::InvalidArgument("sw_extend: empty query or target");

  Params p{o_del, e_del, o_ins, e_ins, end_bonus, zdrop, mat[0], {}};
  for (int t = 0; t < 5; ++t)
    for (int q = 0; q < kCodes; ++q) {
      p.mat[t * kCodes + q] = q < 5 ? mat[t * 5 + q] : 0;
      if (q < 5) p.max_sc = max(p.max_sc, mat[t * 5 + q]);
    }

  const int blocks = (B + kThreads - 1) / kThreads;
  sw_extend_kernel<<<blocks, kThreads, 0, stream>>>(
      query_t.typed_data(), qlen.typed_data(), target_t.typed_data(),
      tlen.typed_data(), w.typed_data(), h0.typed_data(), B, Q, T, p,
      out->typed_data(), reinterpret_cast<int2*>(scratch->typed_data()));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    BstSwExtend, SwExtendImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()   // query_t (Q, B)
        .Arg<ffi::Buffer<ffi::S32>>()  // qlen (B,)
        .Arg<ffi::Buffer<ffi::U8>>()   // target_t (T, B)
        .Arg<ffi::Buffer<ffi::S32>>()  // tlen (B,)
        .Arg<ffi::Buffer<ffi::S32>>()  // w (B,)
        .Arg<ffi::Buffer<ffi::S32>>()  // h0 (B,)
        .Ret<ffi::Buffer<ffi::S32>>()  // out (6, B)
        .Ret<ffi::Buffer<ffi::S32>>()  // scratch (Q+2, B, 2)
        .Attr<ffi::Span<const int32_t>>("mat")
        .Attr<int32_t>("o_del")
        .Attr<int32_t>("e_del")
        .Attr<int32_t>("o_ins")
        .Attr<int32_t>("e_ins")
        .Attr<int32_t>("end_bonus")
        .Attr<int32_t>("zdrop"));
