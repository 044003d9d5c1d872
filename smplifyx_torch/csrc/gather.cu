// Narrow-phase row gather (K2) and sum-scatter (K3) for Hopper (sm_90a).
//
// Replace the TPU kernels smplifyx_tpu/ops/gather_pallas.py::_gather_kernel
// (K2) and ::_scatter_kernel (K3).  Per lane b of a batch:
//     K2  out[b, r, :] = table[b, ids[b, r], :]                 bit-exact
//     K3  out[b, n, :] = sum over r with ids[b, r] == n of values[b, r, :]
// K3 is K2's VJP.  The collision term runs both twice per evaluation:
// level 1 over the mesh's vertex table (C = 3), level 2 over the unique
// triangles' corner rows (C = 9).
//
// The TPU kernels turn the fetch into one-hot matrix products with a
// three-way bf16 split of the values, because the TPU's row gather runs
// on its scalar core.  Hopper loads and stores rows by address, so both
// kernels here are direct.
//
// Bound on an H100 SXM: bytes.  Neither kernel does arithmetic beyond
// address computation and (K3) one add per element, so the least time is
// the ids, the rows they touch and the output over 3.35 TB/s.  At the
// main path's shapes (256 lanes) every operand fits the 50 MB L2.
//   * K2: one thread per output element, consecutive threads on
//     consecutive floats of a row.  Each id is read once per element of
//     its row (C loads of the same 8 bytes, served from L1); the output is
//     written coalesced.
//   * K3: a segmented sum over ids sorted per lane.  The caller passes the
//     ids sorted (stable) and the permutation that sorts them.  Each thread
//     finds its output row's segment by binary search; then its warp sums
//     the warp's non-empty segments one after another, the 32 lanes
//     striding over the segment and a fixed shuffle tree adding their
//     partial sums.  Segments are long on the main path (the padding slots
//     of the pair and triangle lists all point at one row: thousands of
//     entries), so a thread per segment would serialise them.  Every output
//     row is written once, with no atomics and no zeroing, and the sums add
//     in the same order every run.  Float atomics would contend on the
//     repeated rows and add in a new order each run, and the collision
//     penalty's 1/sigma turns such rounding into a different fit.
// An id outside [0, N) is never dereferenced: K2 writes NaN for it and
// K3 drops it.  The CPU path (torch indexing) raises on such ids.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 16;   // K3's widest row (the main path's is 9)

__global__ void __launch_bounds__(THREADS)
gather_kernel(const float* __restrict__ table, const int64_t* __restrict__ ids,
              float* __restrict__ out, int total, int R, int N, int C) {
    const int e = blockIdx.x * THREADS + threadIdx.x;   // b * R * C + r * C + c
    if (e >= total) return;
    const int row = e / C;                              // b * R + r
    const int c = e - row * C;
    const int b = row / R;
    const int64_t id = ids[row];
    out[e] = (id >= 0 && id < N)
                 ? table[((size_t)b * N + (size_t)id) * C + c]
                 : __int_as_float(0x7fc00000);
}

__device__ int lower_bound(const int64_t* s, int R, int64_t n) {
    int lo = 0, hi = R;                                  // first s[k] >= n
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s[mid] < n) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const int64_t* __restrict__ sorted_ids,
                   const int64_t* __restrict__ perm,
                   const float* __restrict__ values, float* __restrict__ out,
                   int rows, int R, int N, int C) {
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * THREADS + threadIdx.x;  // b * N + n
    int lo = 0, len = 0;
    if (row < rows) {
        const int b = row / N;
        const int64_t n = row - (int64_t)b * N;
        const int64_t* s = sorted_ids + (size_t)b * R;
        lo = lower_bound(s, R, n);
        len = lower_bound(s, R, n + 1) - lo;
        if (len == 0)
            for (int c = 0; c < C; ++c) out[(size_t)row * C + c] = 0.0f;
    }
    // The warp takes its non-empty segments in lane order.
    unsigned todo = __ballot_sync(FULL, len > 0);
    while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int seg_row = __shfl_sync(FULL, row, src);
        const int seg_lo = __shfl_sync(FULL, lo, src);
        const int seg_len = __shfl_sync(FULL, len, src);
        const int b = seg_row / N;
        const int64_t* p = perm + (size_t)b * R + seg_lo;
        const float* vals = values + (size_t)b * R * C;
        float acc[MAX_C];
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) acc[c] = 0.0f;
        for (int k = lane; k < seg_len; k += 32) {
            const float* v = vals + (size_t)p[k] * C;
#pragma unroll
            for (int c = 0; c < MAX_C; ++c)
                if (c < C) acc[c] += v[c];
        }
        // xor tree: every lane ends with the same bits (a + b == b + a)
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) {
            if (c < C) {
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    acc[c] += __shfl_xor_sync(FULL, acc[c], off);
            }
        }
        if (lane == src) {
#pragma unroll
            for (int c = 0; c < MAX_C; ++c)
                if (c < C) out[(size_t)seg_row * C + c] = acc[c];
        }
    }
}

}  // namespace

// table [B, N, C], ids [B, R] int64, out [B, R, C]; f32, contiguous, on the
// current device, B * R * C and B * N * C below 2^31.  Launches on `stream`
// and returns the launch's cudaError_t (0 on success).
extern "C" int gather_rows_forward(const float* table, const int64_t* ids,
                                   float* out, int B, int N, int R, int C,
                                   void* stream) {
    const long long total = (long long)B * R * C;
    if (total <= 0) return 0;
    const int blocks = (int)((total + THREADS - 1) / THREADS);
    gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        table, ids, out, (int)total, R, N, C);
    return (int)cudaGetLastError();
}

// sorted_ids [B, R] int64 (each lane ascending), perm [B, R] int64 (the
// stable permutation that sorts each lane's ids), values [B, R, C],
// out [B, num_rows, C]: every output row written once.
extern "C" int scatter_add_rows_forward(const int64_t* sorted_ids,
                                        const int64_t* perm,
                                        const float* values, float* out,
                                        int B, int R, int C, int num_rows,
                                        void* stream) {
    const long long rows = (long long)B * num_rows;
    if (rows <= 0 || C <= 0) return 0;
    if (C > MAX_C) return (int)cudaErrorInvalidValue;
    const int blocks = (int)((rows + THREADS - 1) / THREADS);
    segment_sum_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        sorted_ids, perm, values, out, (int)rows, R, num_rows, C);
    return (int)cudaGetLastError();
}
