// K4: stage-6 forward blend — a 64-thread CTA per work item, a 2x2 pixel
// quad per thread; a work item is a 16x16 tile's list, or a chunk of it.
//
// Replaces the Pallas kernel easygaussiansplatting_tpu/ops/pallas/kernels.py
// `forward_kernel` (reached through ops/pallas/rasterize.py `_fwd_call` and
// `rasterize_pallas`). Plain version: ops/rasterize_tiled.py with
// ops/blend.py.
//
// The TPU kernel streams a packed [M,16] patch array through a (chunk x tile)
// segment grid, turns the per-pixel recurrence into sublane prefix products
// and an MXU contraction, and skips saturated tiles with an SMEM flag. None of
// that is needed here. The walk of a list:
//   * thread t blends the 2x2 pixel quad (t % 8, t / 8) in tile-local
//     coordinates (means shifted by the tile origin), four independent
//     transmittance chains a thread;
//   * the list is staged in shared memory in batches of BATCH entries, each
//     gathered from the K1 table through patch_gsid with its conic
//     pre-scaled (blend.cuh) — no packed per-patch array exists in memory;
//   * each thread walks the batch front to back, reading an entry from
//     shared memory once for its four pixels and evaluating the four pairs
//     without a branch (selects, not jumps, so the four chains interleave);
//     a pixel is done once its transmittance falls below 1e-4, a thread
//     once all four are, the CTA (via __syncthreads_count) once every pixel
//     is.
//
// Two ways to cut the work (the host's plan, ops/kernels/rasterize.py
// `fwd_plan`, picks the chunk length L from the tile count and the card's
// resident CTAs):
//   * L = 0, a frame whose tiles fill the card: a CTA a tile, the whole
//     list, as one item (rasterize_fwd_kernel, as before the chunks).
//   * L > 0, a frame of few tiles (a 160x120 preview has 80, whose deepest
//     walks run to ~10k entries): each list is cut into chunks of L
//     entries, (tile, chunk) is an item, and a grid of resident CTAs takes
//     items from an atomic ticket in chunk-major order (every tile's chunk
//     0, then every tile's chunk 1, ...), so the first wave covers every
//     tile to the same depth. A CTA walks its chunk from tau = 1 (its local
//     colour, tau and last contributor), then waits for the chunk before it
//     to publish its inclusive state (a chain through a per-tile sequence
//     word; the ticket order guarantees the predecessor was taken by a
//     running CTA, so the wait ends) and combines it front to back per
//     pixel, with the stop decided by the walk:
//       - tau_in < 1e-4: the pixel stopped before the chunk and takes
//         nothing from it;
//       - tau_in * tau_local >= 1e-4 * (1 + COMBINE_MARGIN): no entry of
//         the chunk can meet the stop (tau only falls, and the margin
//         covers the two products' rounding over L factors), so the pixel
//         takes C_in + tau_in * C_local and tau_in * tau_local, and the
//         chunk's last contributor if it has one;
//       - tau_in * tau_local < 1e-4 * (1 - COMBINE_MARGIN): the pixel stops
//         inside the chunk for sure. It passes on stopped, its input kept
//         with tau negated (a mark no real tau has), and once the chunk has
//         passed its state on, the chunk walks such pixels again from
//         (C_in, tau_in), entry by entry, and writes their outputs: the
//         stop is decided by the walk, and off the chain's path;
//       - between the two (within the margin of 1e-4): the pixel is walked
//         again before the state passes on.
//     So a pixel's contributors are exactly its live entries before
//     `contrib`, as K5's replay needs. The chunk that ends the tile (its
//     last, or the first after which every pixel is stopped) writes the
//     outputs of its pixels not marked and marks the tile done; any other
//     publishes its inclusive state in one of the tile's two slots (chunk
//     k + 2 writes k's slot only after reading k + 1's, which k + 1
//     published after reading k's). A chunk of a done tile leaves: at its
//     ticket, at a batch boundary of its walk, or at the wait. The order of
//     every combine is fixed, so two calls give bit-equal outputs whatever
//     order the CTAs ran in. A CTA leaves the grid once its ticket's chunk
//     index passes every live tile's chunk count.
//
// Outputs go straight to image [3,H,W], final_tau [H,W] and contrib [H,W],
// with no write for pixels past W or H; empty tiles write colour 0, tau 1,
// contrib 0. In chunks the kernel also counts, in the first three words of
// its state, the items walked, the items left on a done tile and the pixels
// walked again.
//
// What bounds it on an H100: instruction issue and latency. Each (entry,
// pixel) pair costs the exponent (5 FP32 operations, the offsets shared by
// the quad), one ex2 on the MUFU and ~12 more operations and selects. A
// pixel a thread (256 threads, branches) takes ~40 instructions a
// warp-iteration; here the entry's shared loads and loop
// control serve four pixels, the conic comes pre-scaled for ex2.approx in
// place of the accurate expf, and the branch-free body lets a warp issue its
// four chains back to back. (A per-warp skip of entries past blend.cuh's
// cutoff, as K5 has, measured slower here: its votes cost more than the
// exponentials they save.) The gather of table rows is a few tens of MB.
// A CTA a tile leaves a frame of few tiles bound by its deepest tile's
// walk on 2 warps of one SM; chunks spread that walk over the card.
//
// Contract (ops/rasterize_ref.py, kernels.py): alpha' = min(0.99, alpha *
// exp(-0.5 * max(0, maha))); skip alpha' < 0.002; an entry contributes iff
// the tau before it is >= 1e-4; contrib is the 1-based position in the tile's
// list of the last contributing entry and final_tau the tau after it.
// Gaussian ids of -1 contribute nothing.

#include <cuda_runtime.h>

#include "blend.cuh"
#include "memory_order.cuh"

namespace {

using namespace egs_blend;

constexpr int BATCH = 128;  // entries per staged batch
// The longest chunk: the combine's margin covers the rounding of 2 L + 1
// float32 products (2^-24 relative each) for L up to here.
constexpr int MAX_CHUNK = 4096;
constexpr float COMBINE_MARGIN = 1e-3f;
// state words: the three counters, then the ticket, then a sequence word a
// tile (the number of its chunks published, or TILE_DONE)
constexpr int N_COUNTERS = 3;
constexpr int TICKET = N_COUNTERS;
constexpr int STATE_HEAD = 4;
constexpr unsigned TILE_DONE = 0xffffffffu;
constexpr int PLANES = 5;  // a slot: c0, c1, c2, tau, contrib, a float4 a thread each

__device__ __forceinline__ float max_tau(const float (&tau)[PIX]) {
  float m = tau[0];
#pragma unroll
  for (int i = 1; i < PIX; ++i) m = fmaxf(m, tau[i]);
  return m;
}

// One staged entry (position `pos` + 1 in the tile's list) into a thread's
// four chains, branch-free: the four pixels' chains interleave. The chunk
// kernel's step; the tile kernel writes the same step out.
__device__ __forceinline__ void blend_step(float4 p, float4 q, float2 gb, int lx, int ly,
                                           int pos, float (&tau)[PIX],
                                           float (&c0)[PIX], float (&c1)[PIX],
                                           float (&c2)[PIX], int (&cont)[PIX]) {
  float dx[QX], dy[QY];
#pragma unroll
  for (int a = 0; a < QX; ++a) dx[a] = p.x - (float)(lx + a);
#pragma unroll
  for (int b = 0; b < QY; ++b) dy[b] = p.y - (float)(ly + b);
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const float ap = blend_alpha(q, blend_exponent(p, q.x, dx[i % QX], dy[i / QX]));
    const bool use = tau[i] >= TAU_STOP && ap >= ALPHA_SKIP;  // tau < 1e-4: done
    const float w = use ? tau[i] * ap : 0.0f;
    c0[i] = fmaf(w, q.w, c0[i]);
    c1[i] = fmaf(w, gb.x, c1[i]);
    c2[i] = fmaf(w, gb.y, c2[i]);
    cont[i] = use ? pos + 1 : cont[i];
    tau[i] = use ? tau[i] * (1.0f - ap) : tau[i];
  }
}

// table rows: ux uy ca cb | cc alpha r g | b ... (ld floats per row, ld % 4 == 0).
// A CTA a tile, its whole list.
__global__ void __launch_bounds__(NT)
rasterize_fwd_kernel(const float* __restrict__ table, int ld,
                     const int* __restrict__ patch_gsid,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_cnt, int gx, int width,
                     int height, float* __restrict__ image,
                     float* __restrict__ final_tau, int* __restrict__ contrib) {
  __shared__ float4 s_p[BATCH];
  __shared__ float4 s_q[BATCH];
  __shared__ float2 s_gb[BATCH];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = t % gx, ty = t / gx;
  const int lx = QX * (tid % COLS), ly = QY * (tid / COLS);
  const float ox = (float)(tx * TILE), oy = (float)(ty * TILE);
  const int start = tile_start[t];
  const int cnt = tile_cnt[t];

  // A pixel is done once tau < TAU_STOP; pixels past W or H start done
  // (tau 0) and are never written.
  float tau[PIX], c0[PIX], c1[PIX], c2[PIX];
  int cont[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int px = tx * TILE + lx + i % QX, py = ty * TILE + ly + i / QX;
    tau[i] = px < width && py < height ? 1.0f : 0.0f;
    c0[i] = c1[i] = c2[i] = 0.0f;
    cont[i] = 0;
  }

  for (int b0 = 0; b0 < cnt; b0 += BATCH) {
    // every pixel done -> the whole block leaves (also the barrier that
    // keeps the previous batch's shared rows alive until all have read them)
    if (__syncthreads_count(max_tau(tau) < TAU_STOP) == NT) break;
    const int nb = min(BATCH, cnt - b0);
    for (int j = tid; j < nb; j += NT) {
      stage_entry<false>(table, ld, patch_gsid[start + b0 + j], ox, oy, &s_p[j], &s_q[j],
                         &s_gb[j]);
    }
    __syncthreads();
    // the step of blend_step, written out: through the helper this kernel
    // compiled to other code, 5-7.5% slower on an H100
    for (int k = 0; k < nb; ++k) {
      if (max_tau(tau) < TAU_STOP) break;
      const float4 p = s_p[k];
      const float4 q = s_q[k];
      const float2 gb = s_gb[k];
      float dx[QX], dy[QY];
#pragma unroll
      for (int a = 0; a < QX; ++a) dx[a] = p.x - (float)(lx + a);
#pragma unroll
      for (int b = 0; b < QY; ++b) dy[b] = p.y - (float)(ly + b);
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        // branch-free: the four pixels' chains interleave
        const float ap = blend_alpha(q, blend_exponent(p, q.x, dx[i % QX], dy[i / QX]));
        const bool use = tau[i] >= TAU_STOP && ap >= ALPHA_SKIP;  // tau < 1e-4: done
        const float w = use ? tau[i] * ap : 0.0f;
        c0[i] = fmaf(w, q.w, c0[i]);
        c1[i] = fmaf(w, gb.x, c1[i]);
        c2[i] = fmaf(w, gb.y, c2[i]);
        cont[i] = use ? b0 + k + 1 : cont[i];
        tau[i] = use ? tau[i] * (1.0f - ap) : tau[i];
      }
    }
  }

  const size_t hw = (size_t)height * width;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int px = tx * TILE + lx + i % QX, py = ty * TILE + ly + i / QX;
    if (px < width && py < height) {
      const size_t pix = (size_t)py * width + px;
      image[pix] = c0[i];
      image[hw + pix] = c1[i];
      image[2 * hw + pix] = c2[i];
      final_tau[pix] = tau[i];
      contrib[pix] = cont[i];
    }
  }
}

// The chunked kernel's pieces.

// A thread's four pixels.
struct Quad {
  float c0[PIX], c1[PIX], c2[PIX], tau[PIX];
  int cont[PIX];
};

struct Stage {
  float4 p[BATCH];
  float4 q[BATCH];
  float2 gb[BATCH];
  int item;   // thread 0's ticket, then its reads of the tile's sequence word
  int watch;  // the walk's read of it
  int red[NT / 32];
};

// Blend entries [b, e) of the tile's list (from patch_gsid[start]) into q,
// front to back. With `watch` (a chunk that may be speculative), thread 0
// reads the tile's sequence word at each batch boundary; returns false,
// every thread alike, once it reads TILE_DONE.
__device__ __forceinline__ bool walk(Quad& q, const float* __restrict__ table, int ld,
                                     const int* __restrict__ patch_gsid, int start, int b,
                                     int e, float ox, float oy, int lx, int ly,
                                     const unsigned* watch, Stage& s) {
  const int tid = threadIdx.x;
  for (int b0 = b; b0 < e; b0 += BATCH) {
    if (watch != nullptr && tid == 0) s.watch = load_relaxed(watch) == TILE_DONE;
    // every pixel done -> the whole block leaves (also the barrier that
    // keeps the previous batch's shared rows alive until all have read them)
    if (__syncthreads_count(max_tau(q.tau) < TAU_STOP) == NT) break;
    if (watch != nullptr && s.watch) return false;
    const int nb = min(BATCH, e - b0);
    for (int j = tid; j < nb; j += NT) {
      stage_entry<false>(table, ld, patch_gsid[start + b0 + j], ox, oy, &s.p[j], &s.q[j],
                         &s.gb[j]);
    }
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      if (max_tau(q.tau) < TAU_STOP) break;
      const float4 p = s.p[k];
      const float4 qq = s.q[k];
      const float2 gb = s.gb[k];
      blend_step(p, qq, gb, lx, ly, b0 + k, q.tau, q.c0, q.c1, q.c2, q.cont);
    }
  }
  return true;
}

// Walk entries [b, e) again for the pixels of `mask` alone, from their
// state in q; the others stay as they were.
__device__ __forceinline__ void walk_again(Quad& q, unsigned mask, const float* table, int ld,
                                           const int* patch_gsid, int start, int b, int e,
                                           float ox, float oy, int lx, int ly, Stage& s) {
  float kept[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    kept[i] = q.tau[i];
    if (!(mask >> i & 1u)) q.tau[i] = 0.0f;  // done: the walk passes it by
  }
  walk(q, table, ld, patch_gsid, start, b, e, ox, oy, lx, ly, nullptr, s);
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    if (!(mask >> i & 1u)) q.tau[i] = kept[i];
  }
}

// A fresh walk's start: colour 0, contrib 0, tau 1 (0 for pixels past W or
// H: they start done and are never written).
__device__ __forceinline__ void start_quad(Quad& q, int px0, int py0, int width, int height) {
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int px = px0 + i % QX, py = py0 + i / QX;
    q.tau[i] = px < width && py < height ? 1.0f : 0.0f;
    q.c0[i] = q.c1[i] = q.c2[i] = 0.0f;
    q.cont[i] = 0;
  }
}

// The outputs of the pixels of `mask` that lie inside the frame.
__device__ __forceinline__ void write_pixels(const Quad& q, unsigned mask, int px0, int py0,
                                             int width, int height, float* __restrict__ image,
                                             float* __restrict__ final_tau,
                                             int* __restrict__ contrib) {
  const size_t hw = (size_t)height * width;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int px = px0 + i % QX, py = py0 + i / QX;
    if ((mask >> i & 1u) && px < width && py < height) {
      const size_t pix = (size_t)py * width + px;
      image[pix] = q.c0[i];
      image[hw + pix] = q.c1[i];
      image[2 * hw + pix] = q.c2[i];
      final_tau[pix] = q.tau[i];
      contrib[pix] = q.cont[i];
    }
  }
}

// A slot's five planes of NT float4, a thread's four pixels in each.
__device__ __forceinline__ void store_slot(float4* __restrict__ slot, const Quad& q) {
  const int tid = threadIdx.x;
  __stcg(&slot[tid], make_float4(q.c0[0], q.c0[1], q.c0[2], q.c0[3]));
  __stcg(&slot[NT + tid], make_float4(q.c1[0], q.c1[1], q.c1[2], q.c1[3]));
  __stcg(&slot[2 * NT + tid], make_float4(q.c2[0], q.c2[1], q.c2[2], q.c2[3]));
  __stcg(&slot[3 * NT + tid], make_float4(q.tau[0], q.tau[1], q.tau[2], q.tau[3]));
  __stcg(reinterpret_cast<int4*>(&slot[4 * NT + tid]),
         make_int4(q.cont[0], q.cont[1], q.cont[2], q.cont[3]));
}

__device__ __forceinline__ void load_slot(const float4* __restrict__ slot, Quad& q) {
  const int tid = threadIdx.x;
  const float4 a = __ldcg(&slot[tid]), b = __ldcg(&slot[NT + tid]),
               c = __ldcg(&slot[2 * NT + tid]), t = __ldcg(&slot[3 * NT + tid]);
  const int4 n = __ldcg(reinterpret_cast<const int4*>(&slot[4 * NT + tid]));
  q.c0[0] = a.x, q.c0[1] = a.y, q.c0[2] = a.z, q.c0[3] = a.w;
  q.c1[0] = b.x, q.c1[1] = b.y, q.c1[2] = b.z, q.c1[3] = b.w;
  q.c2[0] = c.x, q.c2[1] = c.y, q.c2[2] = c.z, q.c2[3] = c.w;
  q.tau[0] = t.x, q.tau[1] = t.y, q.tau[2] = t.z, q.tau[3] = t.w;
  q.cont[0] = n.x, q.cont[1] = n.y, q.cont[2] = n.z, q.cont[3] = n.w;
}

// The largest chunk count of a tile not yet done (0 once all are): a CTA
// leaves when its ticket's chunk index reaches it. Asked at the start and
// after each ticket that finds no work. Every thread returns it.
__device__ __forceinline__ int live_chunks(const int* __restrict__ tile_cnt,
                                           const unsigned* seq, int n_tiles, int chunk,
                                           Stage& s) {
  int m = 0;
  for (int t = threadIdx.x; t < n_tiles; t += NT) {
    if (load_relaxed(&seq[t]) != TILE_DONE) m = max(m, max(1, (tile_cnt[t] + chunk - 1) / chunk));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __syncthreads();  // s.red free: every thread has read the last reduction's
  if (threadIdx.x % 32 == 0) s.red[threadIdx.x / 32] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) m = max(m, s.red[w]);
  return m;
}

// counters: a warp's sum of v added to *c by its lane 0
__device__ __forceinline__ void count_warp(unsigned* c, int v) {
  v = __reduce_add_sync(0xffffffffu, v);
  if (threadIdx.x % 32 == 0 && v != 0) atomicAdd(c, (unsigned)v);
}

// Chunks of `chunk` entries, taken from the ticket (state: the counters,
// the ticket and a sequence word a tile, zeroed before the launch; slots:
// two a tile).
__global__ void __launch_bounds__(NT)
rasterize_fwd_kernel(const float* __restrict__ table, int ld,
                     const int* __restrict__ patch_gsid,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_cnt, int gx, int n_tiles, int width,
                     int height, int chunk, float* __restrict__ image,
                     float* __restrict__ final_tau, int* __restrict__ contrib,
                     unsigned* state, float4* slots) {
  __shared__ Stage s;
  const int tid = threadIdx.x;
  const int lx = QX * (tid % COLS), ly = QY * (tid / COLS);
  unsigned* counters = state;
  unsigned* seq = state + STATE_HEAD;
  Quad q;

  int kmax = live_chunks(tile_cnt, seq, n_tiles, chunk, s);
  for (;;) {
    __syncthreads();  // s.item free: every thread has read the last item's
    if (tid == 0) s.item = (int)atomicAdd(&state[TICKET], 1u);
    __syncthreads();
    const unsigned g = (unsigned)s.item;
    const int r = (int)(g / (unsigned)n_tiles), t = (int)(g % (unsigned)n_tiles);
    // kmax only falls and tickets only rise: every later ticket is past it too
    if (r >= kmax) break;
    const int cnt = tile_cnt[t];
    const int nch = max(1, (cnt + chunk - 1) / chunk);
    __syncthreads();  // every thread has read s.item
    if (tid == 0) s.item = r < nch && load_relaxed(&seq[t]) == TILE_DONE;
    __syncthreads();
    if (r >= nch || s.item) {  // no such chunk, or the tile ended before it
      if (s.item && tid == 0) atomicAdd(&counters[1], 1u);
      kmax = live_chunks(tile_cnt, seq, n_tiles, chunk, s);
      continue;
    }
    const int tx = t % gx, ty = t / gx;
    const int px0 = tx * TILE + lx, py0 = ty * TILE + ly;
    const float ox = (float)(tx * TILE), oy = (float)(ty * TILE);
    const int start = tile_start[t];
    const int b = r * chunk, e = min(cnt, b + chunk);
    start_quad(q, px0, py0, width, height);
    if (!walk(q, table, ld, patch_gsid, start, b, e, ox, oy, lx, ly,
              r > 0 ? &seq[t] : nullptr, s)) {
      if (tid == 0) atomicAdd(&counters[1], 1u);
      continue;
    }
    float4* slot = slots + (size_t)t * 2 * PLANES * NT;
    unsigned later = 0;  // bit i: pixel i stops in this chunk, walked again after
    if (r > 0) {
      // the chunk before publishes r (or the tile ends: TILE_DONE)
      if (tid == 0) {
        unsigned v;
        while ((v = load_acquire(&seq[t])) < (unsigned)r) __nanosleep(20);
        s.item = v == TILE_DONE;
      }
      __syncthreads();
      if (s.item) {
        if (tid == 0) atomicAdd(&counters[1], 1u);
        continue;
      }
      Quad in;
      load_slot(slot + ((r - 1) & 1) * PLANES * NT, in);
      unsigned now = 0;  // bit i: pixel i within the margin, walked again now
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        const float tau = in.tau[i] * q.tau[i];
        const bool join = in.tau[i] >= TAU_STOP && tau >= TAU_STOP * (1.0f + COMBINE_MARGIN);
        if (join) {
          q.c0[i] = fmaf(in.tau[i], q.c0[i], in.c0[i]);
          q.c1[i] = fmaf(in.tau[i], q.c1[i], in.c1[i]);
          q.c2[i] = fmaf(in.tau[i], q.c2[i], in.c2[i]);
          q.tau[i] = tau;
          q.cont[i] = q.cont[i] > 0 ? q.cont[i] : in.cont[i];
        } else {  // stopped before (passes on), or stops in this chunk
          q.c0[i] = in.c0[i], q.c1[i] = in.c1[i], q.c2[i] = in.c2[i];
          q.tau[i] = in.tau[i], q.cont[i] = in.cont[i];
          if (in.tau[i] >= TAU_STOP) {
            if (tau < TAU_STOP * (1.0f - COMBINE_MARGIN)) {
              later |= 1u << i;
              q.tau[i] = -in.tau[i];  // stopped; its input kept for the walk
            } else {
              now |= 1u << i;
            }
          }
        }
      }
      if (__syncthreads_or(now != 0)) {
        walk_again(q, now, table, ld, patch_gsid, start, b, e, ox, oy, lx, ly, s);
        count_warp(&counters[2], __popc(now));
      }
    }
    if (tid == 0) atomicAdd(&counters[0], 1u);
    if (r == nch - 1 || __syncthreads_count(max_tau(q.tau) < TAU_STOP) == NT) {
      unsigned real = 0;  // pixels not marked: their state is their output
#pragma unroll
      for (int i = 0; i < PIX; ++i) real |= (q.tau[i] >= 0.0f ? 1u : 0u) << i;
      write_pixels(q, real, px0, py0, width, height, image, final_tau, contrib);
      if (nch > 1 && tid == 0) store_release(&seq[t], TILE_DONE);
    } else {
      store_slot(slot + (r & 1) * PLANES * NT, q);
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        store_release(&seq[t], (unsigned)(r + 1));
      }
    }
    if (__syncthreads_or(later != 0)) {
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        if (later >> i & 1u) q.tau[i] = -q.tau[i];
      }
      walk_again(q, later, table, ld, patch_gsid, start, b, e, ox, oy, lx, ly, s);
      write_pixels(q, later, px0, py0, width, height, image, final_tau, contrib);
      count_warp(&counters[2], __popc(later));
    }
  }
}

}  // namespace

// K4's launch for n_tiles tiles at chunk length `chunk` (0: a CTA a tile)
// on a card that holds `resident` chunk CTAs at once, to three int64s: the
// grid (the tiles, or the resident CTAs), the int32 words of state and the
// float32s of slots it needs (both 0 for a CTA a tile).
extern "C" int egs_rasterize_fwd_plan(int n_tiles, int chunk, int resident, long long* out) {
  if (n_tiles < 0 || chunk < 0 || chunk > MAX_CHUNK || (chunk > 0 && resident <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = chunk ? resident : n_tiles;
  out[1] = chunk ? STATE_HEAD + (long long)n_tiles : 0;
  out[2] = chunk ? (long long)n_tiles * 2 * PLANES * NT * 4 : 0;
  return 0;
}

// table: [N, ld] float32 device, 16-byte aligned, ld % 4 == 0; patch_gsid
// [M], tile_start [T], tile_cnt [T] int32 with T = gx * gy; image [3,H,W],
// final_tau [H,W] float32, contrib [H,W] int32 device outputs. chunk and
// grid: egs_rasterize_fwd_plan's; chunked, `state` and `slots` (16-byte
// aligned) of its sizes (the state is zeroed here, by one memset on the
// stream, and the slots need no initialising); for a CTA a tile both are
// ignored (may be null).
extern "C" int egs_rasterize_fwd(const float* table, int ld, const int* patch_gsid,
                                 const int* tile_start, const int* tile_cnt, int gx, int gy,
                                 int width, int height, int chunk, int grid, float* image,
                                 float* final_tau, int* contrib, unsigned* state,
                                 long long state_words, float* slots, void* stream) {
  if (ld % 4 != 0 || ld < 9) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = gx * gy;
  if (n_tiles <= 0) return 0;
  if (chunk < 0 || chunk > MAX_CHUNK) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk == 0) {
    rasterize_fwd_kernel<<<n_tiles, NT, 0, s>>>(table, ld, patch_gsid, tile_start, tile_cnt,
                                                gx, width, height, image, final_tau, contrib);
    return static_cast<int>(cudaGetLastError());
  }
  if (state == nullptr || slots == nullptr || grid <= 0 ||
      state_words < STATE_HEAD + (long long)n_tiles || !aligned(slots, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaMemsetAsync(state, 0, (size_t)state_words * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  rasterize_fwd_kernel<<<grid, NT, 0, s>>>(table, ld, patch_gsid, tile_start, tile_cnt, gx,
                                           n_tiles, width, height, chunk, image, final_tau,
                                           contrib, state, reinterpret_cast<float4*>(slots));
  return static_cast<int>(cudaGetLastError());
}

// The two K4 kernels (overloads of one name): a CTA a tile, or chunks.
using TileKernel = void (*)(const float*, int, const int*, const int*, const int*, int, int,
                            int, float*, float*, int*);
using ChunkKernel = void (*)(const float*, int, const int*, const int*, const int*, int, int,
                             int, int, int, float*, float*, int*, unsigned*, float4*);

const void* egs_blend::fwd_kernel(bool split) {
  return split ? reinterpret_cast<const void*>(static_cast<ChunkKernel>(rasterize_fwd_kernel))
               : reinterpret_cast<const void*>(static_cast<TileKernel>(rasterize_fwd_kernel));
}

// K4's (kernel 0: a CTA a tile; kernel 2: chunks) or K5's (kernel 1)
// registers a thread and resident blocks of NT threads an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), written to out[0..1].
extern "C" int egs_rasterize_info(int kernel, int* out) {
  if (kernel < 0 || kernel > 2) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel == 1 ? egs_blend::bwd_kernel() : egs_blend::fwd_kernel(kernel == 2);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fn, NT, 0));
}
