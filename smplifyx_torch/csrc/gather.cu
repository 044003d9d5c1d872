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
// the ids, the rows they touch and the output over 3.35 TB/s.
//
// Both kernels read a row plan [B, 3, R] int32 (ops/gather.py `row_plan`):
// per lane the ids, the stable order that sorts them and the sorted ids.
// The collision term builds it once per broad phase, since the ids are
// fixed until the next one: the sort is off the gradient's path.
//
//   * K2: a 2-D grid, the lane in blockIdx.y, one thread per output row.
//     The width C is a template parameter (3 and 9; any other C takes a
//     generic path), so there is no runtime division.  Each thread reads
//     its id once (int32 from the plan, or int64 from a caller without
//     one) and its row through the read-only path, and stages it in
//     shared memory; the block then writes its contiguous output span as
//     16-byte vectors.
//   * K3: a segmented sum over the sorted positions, in two launches.
//     k3_scatter_tiles: a 2-D grid of tiles (256 threads x 4 positions at
//     C = 9, x 2 otherwise), the lane in blockIdx.y, no block waiting on
//     another.  Each warp copies its positions' value rows into shared
//     memory with asynchronous 4-byte copies, consecutive threads on
//     consecutive floats, so a warp reads whole rows (a thread fetching
//     its own rows issues one 32-sector request per float).  Each thread
//     sums the runs of equal ids in its positions in order; a segmented
//     scan (a fixed shuffle tree within each warp, then the warps' totals
//     in warp order) completes a run that spans threads or warps.  A run
//     that crosses a tile edge leaves each tile's share in `part`, and
//     k3_join adds the shares tile by tile in order.  So a long run (the
//     padding slots of the pair list all point at one row: ~7,700 of 8,192
//     entries; three vertices take ~1,600 each at level 1) is split over
//     every tile it spans, and a short one costs one thread.  The order of
//     every sum depends only on the ids: the result is the same every run,
//     with no atomics on values.  Padding entries are summed like the
//     others (a NaN in them propagates, as with index_add_).  Every output
//     row is written once: a run's row by the thread or join that ends it,
//     an empty row with zeros by the tile whose id range holds it (a
//     shared-memory bitmap marks the rows its ids name).
// An id outside [0, N) is never dereferenced: K2 writes NaN for it and
// K3 drops it.  The CPU path (torch indexing) raises on such ids.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATHER_THREADS = 256;   // K2: output rows per block
constexpr int SCATTER_THREADS = 256;  // K3: threads per tile
constexpr int WARPS = SCATTER_THREADS / 32;
constexpr int JOIN_THREADS = 128;     // K3's second pass
constexpr int FILL_ROWS = 8192;       // K3: rows per zero-fill window
constexpr int MAX_C = 16;             // K3's widest row (main path: 9)
constexpr unsigned FULL = 0xffffffffu;

// The row width: the template's when fixed, else the runtime one.
template <int CT>
__device__ __forceinline__ int width(int C) { return CT > 0 ? CT : C; }

template <int CT, typename Id>
__global__ void __launch_bounds__(GATHER_THREADS)
k2_gather_rows(const float* __restrict__ table, const Id* __restrict__ ids,
               long long id_stride, float* __restrict__ out, int N, int R,
               int C) {
    constexpr int CS = CT > 0 ? CT : 1;
    __shared__ float stage[GATHER_THREADS * CS];
    const int b = blockIdx.y;
    const int r0 = blockIdx.x * GATHER_THREADS;
    const int r = r0 + threadIdx.x;
    const int w = width<CT>(C);
    const float* tab = table + (size_t)b * N * w;
    const float nan = __int_as_float(0x7fc00000);
    const long long id = r < R ? (long long)ids[(size_t)b * id_stride + r] : -1;
    const bool ok = id >= 0 && id < N;
    if (CT > 0) {
        if (r < R) {
#pragma unroll
            for (int c = 0; c < CS; ++c) {
                float x = nan;
                if (ok) x = __ldg(tab + id * CS + c);
                stage[threadIdx.x * CS + c] = x;
            }
        }
        __syncthreads();
        // The block's span of the output: scalar stores up to the first
        // 16-byte boundary, 16-byte vectors, scalar stores for the tail.
        float* dst = out + ((size_t)b * R + r0) * CS;
        const int n = min(GATHER_THREADS, R - r0) * CS;
        const int head = min(n, (int)((4 - (((uintptr_t)dst >> 2) & 3)) & 3));
        if ((int)threadIdx.x < head) dst[threadIdx.x] = stage[threadIdx.x];
        const int nvec = (n - head) >> 2;
        float4* d4 = reinterpret_cast<float4*>(dst + head);
        for (int k = threadIdx.x; k < nvec; k += GATHER_THREADS) {
            const float* s = stage + head + 4 * k;
            d4[k] = make_float4(s[0], s[1], s[2], s[3]);
        }
        for (int k = head + 4 * nvec + threadIdx.x; k < n; k += GATHER_THREADS)
            dst[k] = stage[k];
    } else if (r < R) {
        float* dst = out + ((size_t)b * R + r) * w;
        for (int c = 0; c < w; ++c) {
            float x = nan;
            if (ok) x = __ldg(tab + id * w + c);
            dst[c] = x;
        }
    }
}

// K3's layout for a row width: positions per thread, the tile, and the
// shared-memory stride of a thread's rows (odd, so that the threads of a
// warp read their rows from distinct banks).
template <int CT>
struct K3Shape {
    static constexpr int CW = CT > 0 ? CT : MAX_C;   // floats per row slot
    static constexpr int ITEMS = CT == 9 ? 4 : 2;
    static constexpr int TILE = SCATTER_THREADS * ITEMS;
    static constexpr int WARP_ROWS = 32 * ITEMS;
    static constexpr int STRIDE = ITEMS * CW + 1 - (ITEMS * CW) % 2;
};

// One tile of one lane's sorted positions.  part[((b * tiles + k) * 2 + s)
// * C ...] receives the tile's share of a run that crosses its edges:
// s = 0 the share of a run that began in an earlier tile, s = 1 of a run
// that began here and goes on into the next tile; k3_join adds them up.
template <int CT>
__global__ void __launch_bounds__(SCATTER_THREADS, 3)
k3_scatter_tiles(const int* __restrict__ plan, const float* __restrict__ values,
                 float* __restrict__ out, float* __restrict__ part, int R,
                 int N, int C) {
    using S = K3Shape<CT>;
    constexpr int CW = S::CW, ITEMS = S::ITEMS;
    __shared__ float s_val[WARPS][32 * S::STRIDE];  // each warp's rows
    __shared__ int s_ord[WARPS][S::WARP_ROWS];      // ... and their positions
    __shared__ unsigned s_bits[FILL_ROWS / 32];     // rows an id names
    __shared__ float s_warp_val[WARPS][CW];         // each warp's inclusive total
    __shared__ int s_warp_head[WARPS];              // whether a run starts in it
    const int w = width<CT>(C);
    const int b = blockIdx.y, k = blockIdx.x;
    const int base = k * S::TILE, end = min(base + S::TILE, R);
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int* order = plan + (size_t)b * 3 * R + R;
    const int* skey = order + R;
    const float* vals = values + (size_t)b * R * w;
    float* dst = out + (size_t)b * N * w;
    float* tile_part = part + ((size_t)b * gridDim.x + k) * 2 * w;

    // This thread's positions: their ids and their rows' positions.
    const int p0 = base + t * ITEMS;
    int key[ITEMS], ord[ITEMS];
    bool loaded = false;
    if constexpr (ITEMS == 4) {
        if (p0 + ITEMS <= R &&
            (((uintptr_t)(skey + p0) | (uintptr_t)(order + p0)) & 15) == 0) {
            const int4 k4 = *reinterpret_cast<const int4*>(skey + p0);
            const int4 o4 = *reinterpret_cast<const int4*>(order + p0);
            key[0] = k4.x; key[1] = k4.y; key[2] = k4.z; key[3] = k4.w;
            ord[0] = o4.x; ord[1] = o4.y; ord[2] = o4.z; ord[3] = o4.w;
            loaded = true;
        }
    }
    if (!loaded) {
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
            key[i] = p0 + i < R ? skey[p0 + i] : 0;
            ord[i] = p0 + i < R ? order[p0 + i] : 0;
        }
    }
    // The ids around the tile and around the warp, loaded with the above:
    // the previous tile's last, this tile's last, and the ids just before
    // and after this warp's positions.
    const int before_tile = base > 0 ? skey[base - 1] : 0;
    const int tile_last = end > base ? skey[end - 1] : 0;
    int prev = (lane == 0 && p0 > 0 && p0 - 1 < R) ? skey[p0 - 1] : 0;
    int next = (lane == 31 && p0 + ITEMS < R) ? skey[p0 + ITEMS] : 0;

    // Copy the warp's rows into shared memory, consecutive lanes on
    // consecutive floats (a warp reads whole rows), with asynchronous
    // copies: every copy of the thread is in flight at once, and none
    // passes through registers.
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) s_ord[warp][lane * ITEMS + i] = ord[i];
    __syncwarp();
    const int n = max(0, min(S::WARP_ROWS, R - (base + warp * S::WARP_ROWS))) * w;
#pragma unroll
    for (int m = 0; m < ITEMS * CW; ++m) {
        const int e = lane + 32 * m, j = e / w;
        if (e < n)
            __pipeline_memcpy_async(
                &s_val[warp][(j / ITEMS) * S::STRIDE + (j % ITEMS) * CW + (e - j * w)],
                vals + (size_t)s_ord[warp][j] * w + (e - j * w), sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    const float* v = s_val[warp] + lane * S::STRIDE;   // position i, float c: v[i * CW + c]

    // Zero the rows that this tile owns and no id names.  Tile k owns the
    // rows after the previous tile's last id up to its own last id (the
    // lane's last tile up to N), so every row without an id is written
    // once, by one tile.
    const int lo = base == 0 ? 0 : min(max(before_tile, -1), N - 1) + 1;
    const int hi = end == R ? N : min(max(tile_last, -1), N - 1) + 1;
    for (int w0 = lo; w0 < hi; w0 += FILL_ROWS) {
        const int w1 = min(hi, w0 + FILL_ROWS);
        for (int m = t; m < FILL_ROWS / 32; m += SCATTER_THREADS) s_bits[m] = 0u;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < ITEMS; ++i)
            if (p0 + i < R && key[i] >= w0 && key[i] < w1)
                atomicOr(&s_bits[(key[i] - w0) >> 5], 1u << ((key[i] - w0) & 31));
        __syncthreads();
        for (int r = w0 + t; r < w1; r += SCATTER_THREADS)
            if (!((s_bits[(r - w0) >> 5] >> ((r - w0) & 31)) & 1u))
                for (int c = 0; c < w; ++c) dst[(size_t)r * w + c] = 0.0f;
        __syncthreads();
    }

    // Neighbouring ids: from the next and previous lanes (at the warp's
    // edges, those loaded above).
    const int up = __shfl_up_sync(FULL, key[ITEMS - 1], 1);
    const int down = __shfl_down_sync(FULL, key[0], 1);
    if (lane > 0) prev = up;
    if (lane < 31) next = down;

    // This thread's runs, in position order.  A run that began before the
    // thread waits (pend) for the scan's prefix; the others are whole.
    float run[CW], pend_val[CW];
    bool head_seen = false, pend = false, open_end = false;
    int pend_key = 0;
#pragma unroll
    for (int c = 0; c < CW; ++c) run[c] = 0.0f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const int p = p0 + i;
        if (p < R) {
            const bool head = p == 0 || key[i] != (i > 0 ? key[i - 1] : prev);
            const bool tail = p + 1 == R ||
                              key[i] != (i + 1 < ITEMS ? key[i + 1] : next);
#pragma unroll
            for (int c = 0; c < CW; ++c) {
                const float x = c < w ? v[i * CW + c] : 0.0f;
                run[c] = head ? x : run[c] + x;
            }
            head_seen = head_seen || head;
            open_end = !tail && p + 1 == end;   // the tile's last run goes on
            if (tail) {
                if (!head_seen) {
                    pend = true;
                    pend_key = key[i];
#pragma unroll
                    for (int c = 0; c < CW; ++c) pend_val[c] = run[c];
                } else if (key[i] >= 0 && key[i] < N) {
                    float* row = dst + (size_t)key[i] * w;
#pragma unroll
                    for (int c = 0; c < CW; ++c)
                        if (c < w) row[c] = run[c];
                }
            }
        }
    }

    // Segmented scan of (head_seen, run) over the tile.  Combining an
    // earlier (fa, a) with a later (fb, b) gives (fa || fb, fb ? b : a + b).
    bool f = head_seen;
    float x[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) x[c] = run[c];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const bool uf = __shfl_up_sync(FULL, f, d);
#pragma unroll
        for (int c = 0; c < CW; ++c) {
            const float ux = __shfl_up_sync(FULL, x[c], d);
            if (lane >= d && !f) x[c] = ux + x[c];
        }
        if (lane >= d) f = f || uf;
    }
    if (lane == 31) {
        s_warp_head[warp] = f;
#pragma unroll
        for (int c = 0; c < CW; ++c) s_warp_val[warp][c] = x[c];
    }
    __syncthreads();
    // The exclusive prefix: earlier warps in order, then the earlier lanes
    // of this warp (the previous lane's inclusive value).
    float pre[CW];
    bool pre_f = false;
#pragma unroll
    for (int c = 0; c < CW; ++c) pre[c] = 0.0f;
    for (int u = 0; u < warp; ++u) {
        const bool uh = s_warp_head[u];
#pragma unroll
        for (int c = 0; c < CW; ++c)
            pre[c] = uh ? s_warp_val[u][c] : pre[c] + s_warp_val[u][c];
        pre_f = pre_f || uh;
    }
    const bool ef = __shfl_up_sync(FULL, f, 1);
#pragma unroll
    for (int c = 0; c < CW; ++c) {
        const float ex = __shfl_up_sync(FULL, x[c], 1);
        if (lane > 0) pre[c] = ef ? ex : pre[c] + ex;
    }
    if (lane > 0) pre_f = pre_f || ef;

    // The run this thread ends but did not begin: its sum when it began in
    // this tile (a head lies in the prefix), else this tile's share of it.
    if (pend && pend_key >= 0 && pend_key < N) {
        float* row = pre_f ? dst + (size_t)pend_key * w : tile_part;
#pragma unroll
        for (int c = 0; c < CW; ++c)
            if (c < w) row[c] = pre[c] + pend_val[c];
    }
    // The tile's last run, when it goes on into the next tile: its share
    // here (the whole tile when no run begins in it).
    if (open_end) {
        float* share = head_seen || pre_f ? tile_part + w : tile_part;
#pragma unroll
        for (int c = 0; c < CW; ++c)
            if (c < w) share[c] = head_seen ? run[c] : pre[c] + run[c];
    }
}

// For each tile whose last run began in it and goes on into the next
// tile(s): that run's sum into its row, the tiles' shares added in order.
template <int CT>
__global__ void __launch_bounds__(JOIN_THREADS)
k3_join(const int* __restrict__ plan, const float* __restrict__ part,
        float* __restrict__ out, int B, int tiles, int R, int N, int C) {
    using S = K3Shape<CT>;
    constexpr int CW = S::CW;
    const int w = width<CT>(C);
    const int g = blockIdx.x * blockDim.x + threadIdx.x;   // b * tiles + k
    if (g >= B * tiles) return;
    const int b = g / tiles, k = g - b * tiles;
    const int* skey = plan + (size_t)b * 3 * R + 2 * R;
    const int base = k * S::TILE, end = min(base + S::TILE, R);
    if (end >= R) return;
    const int key = skey[end - 1];
    if (skey[end] != key || (base > 0 && skey[base - 1] == key)) return;
    if (key < 0 || key >= N) return;
    const float* lane_part = part + (size_t)b * tiles * 2 * w;
    float acc[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] = c < w ? lane_part[(2 * k + 1) * w + c] : 0.0f;
    for (int j = k + 1; j < tiles; ++j) {
#pragma unroll
        for (int c = 0; c < CW; ++c)
            if (c < w) acc[c] += lane_part[2 * j * w + c];
        const int end_j = min((j + 1) * S::TILE, R);
        if (end_j == R || skey[end_j] != key) break;
    }
    float* row = out + ((size_t)b * N + key) * w;
#pragma unroll
    for (int c = 0; c < CW; ++c)
        if (c < w) row[c] = acc[c];
}

template <int CT, typename Id>
int launch_gather(const float* table, const Id* ids, long long id_stride,
                  float* out, int B, int N, int R, int C, cudaStream_t s) {
    const dim3 grid((R + GATHER_THREADS - 1) / GATHER_THREADS, B);
    k2_gather_rows<CT, Id><<<grid, GATHER_THREADS, 0, s>>>(
        table, ids, id_stride, out, N, R, C);
    return (int)cudaGetLastError();
}

template <typename Id>
int gather_width(const float* table, const Id* ids, long long id_stride,
                 float* out, int B, int N, int R, int C, cudaStream_t s) {
    switch (C) {
        case 3: return launch_gather<3>(table, ids, id_stride, out, B, N, R, C, s);
        case 9: return launch_gather<9>(table, ids, id_stride, out, B, N, R, C, s);
        default: return launch_gather<0>(table, ids, id_stride, out, B, N, R, C, s);
    }
}

template <int CT>
int launch_scatter(const int* plan, const float* values, float* out,
                   float* part, int B, int R, int N, int C, cudaStream_t s) {
    // At least one tile: with no ids it zero-fills the output.
    const int tiles = max(1, (R + K3Shape<CT>::TILE - 1) / K3Shape<CT>::TILE);
    k3_scatter_tiles<CT><<<dim3(tiles, B), SCATTER_THREADS, 0, s>>>(
        plan, values, out, part, R, N, C);
    const int err = (int)cudaGetLastError();
    if (err != 0 || tiles == 1) return err;
    const int joins = B * tiles;
    k3_join<CT><<<(joins + JOIN_THREADS - 1) / JOIN_THREADS, JOIN_THREADS, 0, s>>>(
        plan, part, out, B, tiles, R, N, C);
    return (int)cudaGetLastError();
}

}  // namespace

// table [B, N, C] f32 contiguous; ids [B, R] int32 (id_bytes 4) or int64
// (id_bytes 8), lane b's row at ids + b * id_stride; out [B, R, C].  On the
// current device, B <= 65535, B * R * C and B * N * C below 2^31.  Launches
// on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int gather_rows_forward(const float* table, const void* ids,
                                   int id_bytes, long long id_stride,
                                   float* out, int B, int N, int R, int C,
                                   void* stream) {
    if (B <= 0 || R <= 0 || C <= 0) return 0;
    if (B > 65535) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (id_bytes == 4)
        return gather_width(table, (const int32_t*)ids, id_stride, out, B, N, R, C, s);
    if (id_bytes == 8)
        return gather_width(table, (const int64_t*)ids, id_stride, out, B, N, R, C, s);
    return (int)cudaErrorInvalidValue;
}

// The tiles of K3 for R sorted positions of width C, so that the caller
// can size `part` (tiles * 2 * C floats per lane).
extern "C" int scatter_add_rows_tiles(int R, int C) {
    const int tile = C == 3 ? K3Shape<3>::TILE : C == 9 ? K3Shape<9>::TILE
                                                        : K3Shape<0>::TILE;
    return R > 0 ? (R + tile - 1) / tile : 1;
}

// plan [B, 3, R] int32 (per lane: ids, stable order, sorted ids), values
// [B, R, C] f32, out [B, num_rows, C] f32, part [B, tiles, 2, C] f32
// scratch: every output row written once, the empty ones with zeros.
// C <= 16, B <= 65535.  Two launches: the tiles, then the runs that cross
// tiles.
extern "C" int scatter_add_rows_forward(const int* plan, const float* values,
                                        float* out, float* part, int B, int R,
                                        int C, int num_rows, void* stream) {
    if (B <= 0 || num_rows <= 0 || C <= 0) return 0;
    if (C > MAX_C || B > 65535) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (C) {
        case 3: return launch_scatter<3>(plan, values, out, part, B, R, num_rows, C, s);
        case 9: return launch_scatter<9>(plan, values, out, part, B, R, num_rows, C, s);
        default: return launch_scatter<0>(plan, values, out, part, B, R, num_rows, C, s);
    }
}
