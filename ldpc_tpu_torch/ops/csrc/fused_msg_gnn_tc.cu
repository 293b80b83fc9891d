// The fully-neural message-GNN decoders on the tensor cores for Hopper
// (sm_90a): the whole forward of a trained MessageGNNDecoder (LLR embedding,
// T GNN layers, output projection, per-variable sum, sigmoid) in one kernel
// launch, its message products as bf16 mma.sync tiles (at h = 128 wgmma
// warpgroup tiles) with float32 accumulators.
//
// Replaces the TPU kernels of ldpc_tpu/ops/pallas_gnn.py:
//   * msg_gnn_tc_kernel<H, INJ>    <- :137 _kernel (make_fused_gnn_decoder,
//                                     pallas_call at :2230), entry point ldpc_msg_gnn
//   * msg_gnn_v2_tc_kernel<H, INJ> <- :295 _kernel_v2 (make_fused_gnn_decoder_v2,
//                                     pallas_call at :519), entry point ldpc_msg_gnn_v2
//   * msg_gnn_v3_tc_kernel<H, INJ> <- :644 _kernel_v3 (make_fused_gnn_decoder_v3,
//                                     pallas_call at :882), entry point ldpc_msg_gnn_v3
//   * msg_gnn_v4_tc_kernel<H, INJ> <- :952 _kernel_v4 (make_fused_gnn_decoder_v4,
//                                     pallas_call at :1225), entry point ldpc_msg_gnn_v4
//   * msg_gnn_wide_tc_kernel<INJ, V> <- :295 and :952 at h = 128 (B7, V = 7, and
//                                     B9, V = 9), entry points ldpc_msg_gnn_v2 and
//                                     ldpc_msg_gnn_v4 with H = 128
// One skeleton; the variant V (6 .. 9, the number of the TPU kernel, B6 ..
// B9) is a template argument.  H is the hidden width, built for 16 and 64,
// and for B7 and B9 also for 128 (kWideH, its weights streamed in chunks);
// INJ is input injection.  The Python wrapper, the packed weight layouts
// (pack_tc_weights) and the plain PyTorch versions (_MsgPlain, _FoldPlain):
// ldpc_tpu_torch/ops/fused_gnn.py.
//
// What B6 and B7 compute, per frame
// ---------------------------------
// Messages are var-aligned per base edge k: message i = k*Z + z belongs to
// variable (col[k], z) and to check (row[k], (z - shift[k]) mod Z).  Each
// message carries h bf16 features f.
//   seed:  f = bf16(llr[col[k], z] * emb_w + emb_b)
//   layer t (weights of layer t rounded to bf16; the type embeddings folded
//   into per-edge first-layer biases b1v[t, k], b1c[t, k], float32):
//     vmean = bf16(sum of f over the variable's messages * (1 / degree))
//     rmean = bf16(sum of f over the check's messages * (1 / degree))
//     per message, with lf = bf16(llr[col[k], z] * emb_w + emb_b) (INJ only):
//       pv  = [f | vmean[col[k], z] | lf] . [W1vf W1va W1vl]^T + b1v[k]
//       pc  = [f | rmean[row[k], (z - shift[k]) mod Z] | lf] . [W1cf W1ca W1cl]^T + b1c[k]
//       h1v = bf16(relu(pv)), h1c = bf16(relu(pc))
//       B6: new = bf16(bf16(W2v h1v + b2v) + bf16(W2c h1c + b2c))
//       B7: new = bf16([h1v | h1c] . [W2v W2c]^T + b2),  b2 = b2v + b2c
//       f   = new at t = 0, bf16(new + f) after (residual from layer 2 on)
//   output: acc = sum over the variable's messages of
//           ((acc + sum_q f[q] * proj_w[q]) + proj_b); soft = 1 / (1 + exp(llr + acc)).
// Against the plain version only the float32 summation order changes: it
// adds the shared first-layer terms as separate products (B6 ((W1vf f +
// (W1va vmean + W1vl lf)) + b1v); B7 ((W1vf f + W1va vmean) + b1v) + W1vl
// lf; both ((W1cf f + W1ca rmean) + b1c) + W1cl lf); here each first-layer
// output is one accumulation over its 2h (3h with injection) inputs, then
// plus b1.  Every bf16 rounding point is the plain version's.
//
// What B8 and B9 compute, per frame
// ---------------------------------
// The type embeddings te_t (per edge) ride in the features; the delta table
// dte (T + 1, K, h), float32, moves them on: block 0 is te_0, block 1 te_1,
// block t >= 2 te_t - te_{t-1}, te_T = 0.  b1v, b1c, b2 = b2v + b2c per
// layer (B8's b2 rounded to bf16: the TPU kernel adds it through a ones-row).
//   seed:  f = bf16((llr[col[k], z] * emb_w + emb_b) + dte[0, k])
//   layer t:
//     vmean   = bf16(sum of f over the variable's messages * (1 / degree))
//     B8: pre_row = (sum over the check's messages of W1ca f) * (1 / degree)
//         + b1c, float32, no bf16 mean
//     B9: rmean as B7's
//     per message, lf as in B7:
//       pv  = [f | vmean | lf] . [W1vf W1va W1vl]^T + b1v
//       B8: pc = ((W1cf f) + pre_row[check]) + W1cl lf
//       B9: pc = [f | rmean | lf] . [W1cf W1ca W1cl]^T + b1c
//       out = bf16([bf16(relu(pv)) | bf16(relu(pc))] . [W2v W2c]^T + b2)
//       d   = bf16(dte[t + 1, k]);  f = bf16(out + d) at t = 0, after:
//             B8 bf16(bf16(out + f) + d), B9 bf16(bf16(out + d) + f)
//   B8 output: as B7.
//   B9's last layer (t = T - 1) writes no features: per message
//     s = w2last . [h1v; h1c] + (T > 1 ? proj8 . f : 0),
//   w2last = bf16(proj [W2v W2c]), proj8 = bf16(proj) (the output projection
//   is linear, so it folds into the last second layer); output acc = sum
//   over the variable's messages, in member order, of ((acc + s) + dsc[k]),
//   dsc = proj_b + proj . b2 - proj . te_{T-1} (float32, per edge).
// The plain version sums B8's pv as (W1vf f + ((W1va vmean + b1v) + W1vl
// lf)), pre_row's products member by member, and b2 inside the second
// product; B9's pv the same way, its pc as ((W1cf f + (W1ca rmean + b1c)) +
// W1cl lf), and s as (w2last . h1) + (proj8 . f); here each is one float32
// accumulation.  B8's pc keeps the plain version's order: pre_row carries a
// factor 1/degree, so it is no multiple of the products' quanta and a sum
// with it would not be exact in another order even on exact inputs.  Every
// bf16 rounding point is the plain version's, in its order: each bf16
// addition rounds (the JAX kernels in interpret mode agree, not one rounding
// at the end of a chain; tests/test_torch_msg_gnn_v34.py).
//
// Design
// ------
// A frame's state does not fit in a block (the features alone are K*Z*h
// bf16, 807 KB at nr_2_0_32 Z=32 h=64), so it lives in a global scratch
// slice per resident block, sized by the grid; frames come from an atomic
// counter.  The slice holds, message-major, one 2h-byte row per message:
// the features [k*Z + z][q], then the means vmean [c*Z + z][q] and (all but
// B8) rmean [r*Z + z][q]; B9 then one float32 output scalar per message.  A
// layer runs in two phases separated by barriers:
//   1. no products: each thread sums one 16-byte chunk (8 features) of one
//      variable's (all but B8: or check's) members, in member order, and
//      stores the bf16 mean; meanwhile cp.async stages the layer's weights.
//   2. B6, B7, B9, message-major: each warp takes 16-message tiles over the
//      flat message index (any Z: the per-row k may change inside a tile).
//      cp.async (16 B a thread) gathers the tile's feature rows, vmean rows
//      at (col, z) and rmean rows at (row, (z - shift) mod Z) into the
//      warp's shared memory, double-buffered: the next tile's rows load
//      while this one computes.  ldmatrix reads the A fragments; the lf
//      fragments are built in registers from the frame's LLRs.  mma.sync
//      m16n8k16 (bf16 in, float32 accumulators) computes pv and pc; their
//      C fragments plus b1, relu and bf16-packed are the A fragments of the
//      second layer, so the first layer's outputs never leave registers.
//      B6 runs the second layer's halves through one accumulator in turn:
//      W2v h1v, plus b2v, rounded and packed into registers as h1v's die;
//      then W2c h1c (one accumulator set: a second would not fit beside
//      B7's 168 registers a thread).  The epilogue adds b2 (B6: b2c, then
//      out_v), the residual read from the staged tile (B9: and the delta,
//      from L2 as float32), writes the tile in place in shared memory and
//      copies it out with 16-byte stores: a message reads only its own row
//      and the means, so the update is in place.  B9's last layer ends
//      after the first layer: s is a thin mma (B4's: the row in column 0 of
//      B, lanes 0..3 hold it) over [h1v | h1c | f], written to the scratch.
//   2. B8, check-major (the shape of B4's check pass, fused_gnn_tc.cu): a
//      warp takes 16 flat checks r*Z + zc a tile, dealt from a queue in the
//      code's order (row degrees differ, the base graphs list heavy rows
//      first).  A tile runs 2 * dmax stages (dmax: its rows' largest
//      degree), each one member slot's rows gathered with cp.async,
//      double-buffered across stages and into the next tile's first:
//        W1ca stages: the features of member s of every row at (k, (zc +
//          shift[k]) mod Z); pre_row accumulates W1ca f over all members in
//          one float32 accumulator; after the last, times 1/degree plus b1c.
//          pre_row stays in registers as C fragments, never in scratch.
//        update stages: member s's features and vmean rows; pv as one
//          product over [f | vmean | lf]; pc 16 outputs at a time, W1cf f
//          plus pre_row plus W1cl lf (the A fragments of f held in
//          registers); relu and bf16 pack into the second layer's A
//          fragments; [W2v
//          W2c]; the epilogue adds b2, the residual and the delta, and the
//          tile goes back in place.  Each message belongs to one check, so
//          its old features are read, for W1ca and for its own update, by
//          the tile that writes them alone.
//      At Z < 16 a tile spans rows of different degree (nr_2_0_4, Z = 4): a
//      slot past a row's degree is a zero A row and writes nothing.  The
//      deltas dte[t + 1] are staged in shared memory as bf16 in phase 1
//      (25 KB at nr_2_0_32 h = 64); reading them from L2 as float32 in the
//      epilogue instead measured 3% slower at the same block shape.
// Weights, per layer, bf16 in shared memory as [out][in] rows, each padded
// by 8 bf16 (16 bytes), not swizzled, so the eight 16-byte rows one ldmatrix
// phase reads fall in eight different bank quads; the staged tiles are
// padded the same way.  B6, B7, B9: W1v, W1c (h x 2h or 3h), W2 = [W2v W2c]
// (h x 2h).  B8: W1v = [W1vf W1va (W1vl)] (h x 2h or 3h), W1c = [W1cf
// (W1cl)] (h x h or 2h), W1ca (h x h), W2 (h x 2h): 53,248 B at h = 64
// (69,632 B with injection).  The wrapper packs them in exactly this layout,
// padding included, so staging is a straight 16-byte copy.  B9's w2last and
// dsc are read from L2 (once a tile in the last layer, once a member in the
// output).
// Shared memory (H = 64, nr_2_0_32 Z = 32): structure, inverse degrees, the
// frame's LLRs, embedding, biases about 13 KB (B6 b2v, b2c; B7 b2; B8, B9
// b1v, b1c, b2); B6, B7, B9: weights 52,224 B (68,608 B with injection),
// 13,824 B of tile buffers per warp; B8: weights as above, the staged deltas
// 25,216 B, 9,216 B of stage buffers per warp.
//
// Block shape: the plan functions ask the runtime's occupancy query for
// every warp count from 1 to kMaxWarps and take the one with the most
// resident warps per SM (ties: the smaller block, so more frames are in
// flight).  The registers a thread are in the build log (-Xptxas -v,
// _build.build_log) and chip_smoke.py prints them beside the plan.
//
// Flags: built without -fmad=false.  The only products are the mma's; every
// elementwise multiply that is followed by an add (the embedding, the mean's
// scale, pre_row's scale, the projection) is written with __fmul_rn /
// __fadd_rn, which the compiler never contracts into an FMA, and the
// remaining float adds have no multiply to contract with.  So the flag
// would change no result here.
//
// What bounds it on the card
// --------------------------
// Per layer of one frame, with E = K*Z messages, n = C*Z variables, M = R*Z
// checks, inj = 1 with input injection (chip_smoke.py msg_bound_ms derives
// the bounds the same way):
//   B6, B7: the least work is (4E + n + M + 2 inj n) (h, h) products by a
//     vector (first layer per message twice on the message's own features,
//     once per variable and check mean, the LLR terms per variable; second
//     layer twice), 2h^2 operations each, bf16 x bf16 -> float32, at the
//     tensor cores' dense bf16 rate, 989e12 per second.  The elementwise
//     float32 work (means, biases, ReLUs, roundings, residual; none an FMA)
//     runs beside it at 33.5e12 per second and is smaller.  LLRs are read
//     and soft bits written once.  Main path (nr_2_0_32 Z=32 h=64, T=20, no
//     injection, batch 2048): 9.576 ms.  This design does 6E products
//     instead (pv and pc each carry their shared term, +34%), 13 ms at the
//     full tensor-core rate; mma.sync with gathered tiles reaches a
//     fraction of it.  Scratch traffic per layer of a frame: phase 1 reads
//     the features twice (1.6 MB) and writes the means (0.39 MB); phase 2
//     reads the features and the gathered mean rows (0.8 + 1.6 MB) and
//     writes the features (0.8 MB): about 5.2 MB, 213 GB for the batch, 64
//     ms at 3.35 TB/s if none of it stays in the 50 MB L2 (132 frames in
//     flight hold 157 MB of scratch).
//   B8: the least work is (5E + n + 2 inj n) products a layer (each
//     message's W1ca product is the TPU kernel's own formula), 11.259 ms at
//     the main path.  This design does 6E (+ 2 inj E: W1vl and W1cl per
//     message) products, 12.8 ms at the full tensor-core rate.  Scratch
//     traffic per layer of a frame: phase 1 reads the features (0.8 MB) and
//     writes vmean (0.2 MB); phase 2 gathers the features twice (1.6 MB)
//     and vmean once per message (0.8 MB) and writes the features (0.8
//     MB): about 4.2 MB, 172 GB for the batch, 51 ms at 3.35 TB/s if none
//     of it stays in L2 (132 frames in flight hold 135 MB of scratch).
//   B9: B6's products for T - 1 layers; the last layer 2E + n + M + 2 inj n
//     products plus 2h (3h after layer 0) multiply-adds per message: 9.367
//     ms at the main path.  This design does B7's 6E products for T - 1
//     layers and 4E plus a thin product in the last, with B7's scratch
//     traffic.
//
// H = 128 (kWideH), B7 and B9: msg_gnn_wide_tc_kernel
// ------------------------------------------------------
// A layer's weights are 262,144 B with injection (196,608 B without): more
// than the 227 KB a block can use.  So they stream through shared memory in
// chunks of kWideChunk = 16 hidden units, in the order and layout the
// wrapper packs them (pack_tc_weights): a chunk is five bf16 matrices in
// core-matrix order (cm), [W1vf; W1cf] (32 x h), W1va and W1ca (16 x h
// each), with injection [W1vl; W1cl] (32 x h), and [W2v W2c] cut to the
// units' columns (h x 32): 32,768 B with injection (24,576 B without),
// filled by one cp.async.bulk into a ring of kWideStages buffers.
// The block is kWideGroups warpgroups of 4 warps; a warpgroup takes tiles
// of kWideRows = 64 consecutive messages (any Z: the edge k may change
// inside a tile), each warp gathering its 16 rows (cp.async) into the
// warpgroup's tile buffer: f, vmean and rmean, with injection also lf,
// each 64 x h in core-matrix order.  Per chunk the warpgroup runs on wgmma:
//   first layer, three products in accumulators of their own
//   (first_products) so that the tensor cores overlap them: f . [W1vf;
//   W1cf]^T plus, with injection, lf . [W1vl; W1cl]^T (m64n32, pv's and
//   pc's units at once), vmean . W1va^T and rmean . W1ca^T (m64n16 each),
//   all with A and B in shared memory; then, in registers, their sum with
//   b1 (first_sums), relu and bf16 packed into h1 = [h1v | h1c], whose C
//   fragments are the A fragments of the second layer: acc += h1 . [W2v
//   W2c]^T, two m64n128k16 with A from registers into the tile's 64 x 128
//   float32 accumulator (64 registers a thread), or B9's last layer: s +=
//   the thin products (mma.sync, B4's) of h1 with w2last, after s = proj8 .
//   f at the first chunk.
// A warpgroup waits for a chunk on its full mbarrier (the fill's bytes) and
// no block barrier a chunk: each warpgroup counts its release of a buffer
// once its products on it have retired (a shared-memory count, the ring's
// empty side), and the last warpgroup to release it refills it with the
// chunk kWideStages on.  A warpgroup without a tile in the last round still
// waits and releases.  The next tile's rows
// load as soon as the last chunk's first layer has read the buffer; the
// epilogue (write_rows_wide) adds b2 (B9: and the delta) and the residual,
// read from the scratch, and writes each thread's pairs of features back.
// Phase 1 (the means, means_wide) keeps four (row, 16-byte chunk) items a
// thread in flight; the frame loop keeps its block barriers.
// Against the h = 64 kernels only the float32 order of sums changes: each
// first-layer product sums in the tensor cores' order (lf's inside f's),
// the products and b1 are added in the plain version's order, the second
// layer chunk by chunk, B9's s with proj8 . f first; every bf16 rounding
// point is the plain version's.  Shared memory at nr_2_0_4 Z = 4: 205,040 B with
// injection (B7), 155,888 B without; one block an SM, 8 warps, up to 255
// registers a thread.  The scratch slice is (K + C + R) Z h bf16 (B9: and a
// float32 a message): 298 KB at nr_2_0_4 Z = 4, 2.38 MB at nr_2_0_32 Z = 32.
// Every round streams the layer's chunks from L2 again (7 rounds a layer of
// 13 tiles at nr_2_0_4 Z = 4).
// Bound, by the formula above at h = 128 (chip_smoke.py msg_bound_ms): the
// ft-floor path's shape (nr_2_0_4 Z = 4, T = 10, injection, batch 4096)
// 5.352 ms for B7, 5.141 ms for B9; msg_gnn_main's shape 38.30 and 37.46
// ms.  Measured on an H100 80GB HBM3 at 700 W (probe_wide_split.py): 45.0
// and 46.4 ms; 306.6 and 312.3 ms, where the design it replaced (mma.sync
// on 16-message tiles a warp, a block barrier a chunk) took 56.4, 48.1,
// 352.9 and 340.9 ms in the same call.  Phase 1 takes 14-19% of the time,
// the tiles' gathers 11-15%, the means' products 6-12%, the second layer
// and the weights' L2 re-stream under 3% each (the split in PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWarps = 12;
constexpr int kTile = 16;  // rows a tile: the mma's M

// H = kWideH streams each layer's weights through shared memory in chunks of
// kWideChunk hidden units (msg_gnn_wide_tc_kernel, B7 and B9 only), a ring of
// kWideStages chunk buffers read by kWideGroups warpgroups of 4 warps, each
// on a tile of kWideRows messages.  Two warpgroups and two stages were
// measured against three of either (ldpc_tpu_torch/tools/probe_wide_split.py
// on an H100 80GB HBM3 at 700 W): three warpgroups leave a thread 168
// registers and spill (B7 427 against 309 ms at msg_gnn_main's shape at
// h = 128); a third stage fits only without injection and moves that shape
// by under 2%.
constexpr int kWideH = 128;
constexpr int kWideChunk = 16;
constexpr int kWideRows = 64;   // messages a warpgroup tile: wgmma's M
constexpr int kWideGroups = 2;  // warpgroups a block
constexpr int kWideStages = 2;  // chunk buffers in the ring
constexpr int kWideWarps = 4 * kWideGroups;
static_assert(kWideH % kWideChunk == 0 && kWideChunk == 16, "a chunk is one k-tile of h1v, h1c");
static_assert(kWideStages >= 2, "a chunk is released one chunk after its wait");

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// The variant V of the skeleton: the TPU kernel it replaces, 6 .. 9 (B6 ..
// B9).  B8 runs check-major tiles, the others B7's message-major tiles; B8
// and B9 carry the type embeddings in the features (the delta table).
__host__ __device__ constexpr bool check_major(int V) { return V == 8; }
__host__ __device__ constexpr bool folded(int V) { return V >= 8; }

// Floats of one layer's biases in a.small, staged whole: B6 b2v, b2c; B7
// b2; B8 and B9 b1v, b1c, b2.
__host__ __device__ constexpr int small_floats(int H, int V) {
  return (V == 7 ? 1 : V == 6 ? 2 : 3) * H;
}

// Per-variant sizes, in bf16 elements: one layer's packed weights (B6, B7,
// B9: W1v, W1c of kin + 8 and W2 of 2h + 8 a row; B8: W1v of kin + 8, W1c of
// kin - h + 8, W1ca of h + 8, W2 of 2h + 8) and the segments of a warp's tile
// buffer (message-major: f, vmean, rmean rows; B8: f, vmean rows).
// One weight chunk at H = kWideH, five matrices in core-matrix order (cm,
// below), unpadded: [W1vf; W1cf] of its kWideChunk hidden units (2 kWideChunk
// x H), W1va (kWideChunk x H), W1ca (kWideChunk x H), with injection [W1vl;
// W1cl] (2 kWideChunk x H), then the H rows of W2 = [W2v W2c] cut to those
// units' columns (H x 2 kWideChunk).  A layer is H / kWideChunk chunks.
__host__ __device__ constexpr int chunk_weights(bool inject) {
  return (inject ? 8 : 6) * kWideChunk * kWideH;
}

__host__ __device__ constexpr int layer_weights(int H, bool inject, int V) {
  return H == kWideH ? kWideH / kWideChunk * chunk_weights(inject)
         : check_major(V)
             ? H * (((inject ? 3 : 2) * H + 8) + ((inject ? 2 : 1) * H + 8) + (H + 8) + (2 * H + 8))
             : H * (2 * ((inject ? 3 : 2) * H + 8) + 2 * H + 8);
}

// Weights a block stages at once: a whole layer, or at H = kWideH the ring.
__host__ __device__ constexpr int staged_weights(int H, bool inject, int V) {
  return H == kWideH ? kWideStages * chunk_weights(inject) : layer_weights(H, inject, V);
}

__host__ __device__ constexpr int tile_segments(int V) { return check_major(V) ? 2 : 3; }

// The matrices of a warpgroup's tile buffer at H = kWideH: f, vmean, rmean
// and, with injection, lf.
__host__ __device__ constexpr int wide_mats(bool inject) { return inject ? 4 : 3; }

// Compile-time shapes of one instantiation, in bf16 elements.
template <int H, bool INJ, int V>
struct Shape {
  static constexpr int WSV = (INJ ? 3 : 2) * H + 8;  // padded row of W1v (message-major: and W1c)
  static constexpr int WSC = (INJ ? 2 : 1) * H + 8;  // B8: padded row of W1c, f (, lf)
  static constexpr int WSA = H + 8;                  // B8: padded row of W1ca
  static constexpr int WS2 = 2 * H + 8;              // padded row of W2
  static constexpr int LW = layer_weights(H, INJ, V);
  static constexpr int AS = H + 8;                   // padded row of a staged tile
  static constexpr int SEG = kTile * AS;             // one staged segment (16 rows)
  static constexpr int BUF = tile_segments(V) * SEG;  // one tile buffer
  static constexpr int CPR = H / 8;                  // 16-byte chunks a row
  static constexpr int RPP = 32 / CPR;               // rows a warp moves per pass
  static constexpr int NT = H / 8;                   // n-tiles of an h-wide output
  static constexpr int KT = H / 16;                  // k-tiles of an h-wide input
};

struct Args {
  const float* llr;          // (B, n)
  float* soft;               // (B, n)
  int* counter;              // next frame to hand out, starts at 0
  __nv_bfloat16* scratch;    // (grid, scratch_elems): features, vmean (, rmean) (, B9's s)
  const int* graph;          // row_ptr, row_edge, col_ptr, col_edge, shift, col, row, type
  const float* inv;          // 1/degree per column (C), then per row (R)
  const __nv_bfloat16* w;    // (T, LW) packed, padded rows
  const float* tab;          // B6, B7 (T, 2, K, H): b1v, b1c per edge (type embeddings
                             // folded in); B8, B9 (T + 1, K, H): the delta table dte
  const float* small;        // (T, small_floats): B6 b2v, b2c; B7 b2 = b2v + b2c;
                             // B8 b1v, b1c, bf16(b2); B9 b1v, b1c, b2
  const float* emb;          // emb_w (H), emb_b (H), proj_w (H), proj_b; B9: bf16(proj_w), 0
  const float* extra;        // B9: w2last (2H), dsc (K); unused otherwise
  int B, Z, R, C, K, T;
};

// Byte offsets of a block's dynamic shared memory (all 16-byte aligned).
struct Layout {
  int graph, inv, llr, emb, small, w, dte, stage, bar, total;
};

__host__ __device__ inline Layout make_layout(int H, int inject, int Z, int R, int C, int K,
                                              int warps, int V) {
  Layout L;
  int o = 0;
  L.graph = o; o += 4 * round4(6 * K + R + C + 2);
  L.inv = o; o += 4 * round4(C + R);
  L.llr = o; o += 4 * round4(C * Z);
  L.emb = o; o += 4 * round4(3 * H + 1);
  L.small = o; o += 4 * small_floats(H, V);
  L.w = o; o += 2 * staged_weights(H, inject, V);
  L.dte = o; o += check_major(V) ? 2 * K * H : 0;  // B8: dte[t + 1], bf16
  // A warp's two tile buffers; at H = kWideH a warpgroup's one (f, vmean and
  // rmean of kWideRows messages, core-matrix order), then the ring's full
  // barriers and release counts.
  L.stage = o;
  o += H == kWideH ? warps / 4 * wide_mats(inject) * 2 * kWideRows * H
                   : warps * 2 * 2 * tile_segments(V) * kTile * (H + 8);
  L.bar = o; o += H == kWideH ? 2 * 8 * kWideStages : 0;
  L.total = o;
  return L;
}

// bf16 elements of one block's scratch: features (K*Z rows) and vmean (C*Z),
// h each; message-major, then rmean (R*Z rows); B9, then each message's
// output scalar (K*Z float32, rounded up to 16 bytes).
__host__ __device__ inline long long scratch_elems(int V, int H, int Z, int R, int C, int K) {
  if (check_major(V)) return static_cast<long long>(K + C) * Z * H;
  return static_cast<long long>(K + C + R) * Z * H + (V == 9 ? 2LL * round4(K * Z) : 0);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, lo in the low half (the lower
// column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x[0..7] += the 8 bf16 features in v (16 bytes).
__device__ __forceinline__ void add8(float (&x)[8], const uint4& v) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(b[e]);
    x[2 * e] = __fadd_rn(x[2 * e], f.x);
    x[2 * e + 1] = __fadd_rn(x[2 * e + 1], f.y);
  }
}

// x[0..7] = the sum, in member order, of chunk u of the feature rows
// row(j) for j in [begin, end): four rows' loads in flight at a time.
template <int H, typename Row>
__device__ __forceinline__ void sum_members(float (&x)[8], const __nv_bfloat16* feats, int u,
                                            int begin, int end, Row&& row) {
  auto chunk = [&](int j) {
    return *reinterpret_cast<const uint4*>(feats + static_cast<size_t>(row(j)) * H + u * 8);
  };
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = 0.0f;
  int j = begin;
  for (; j + 4 <= end; j += 4) {
    const uint4 v0 = chunk(j), v1 = chunk(j + 1), v2 = chunk(j + 2), v3 = chunk(j + 3);
    add8(x, v0);
    add8(x, v1);
    add8(x, v2);
    add8(x, v3);
  }
  for (; j < end; ++j) add8(x, chunk(j));
}

// The bf16 embedding of LLR m at features q, q + 1.
__device__ __forceinline__ uint32_t embed2(float m, const float* emb_w, const float* emb_b,
                                           int q) {
  return pack_bf16(__fadd_rn(__fmul_rn(m, emb_w[q]), emb_b[q]),
                   __fadd_rn(__fmul_rn(m, emb_w[q + 1]), emb_b[q + 1]));
}

struct Graph {
  const int *row_ptr, *row_edge, *col_ptr, *col_edge, *shift, *col, *row;
};

// Pointers into a block's shared memory and scratch.
struct Block {
  Graph g;
  const float *inv_dc, *inv_dr, *emb_w, *emb_b, *proj_w;
  float* llr;
  float* small;          // the staged layer's biases: B7 b2; B8 b1v, b1c, b2
  __nv_bfloat16* w;      // the staged layer's weights (H = kWideH: the chunk ring)
  __nv_bfloat16* dte;    // B8: the staged dte[t + 1] (K x H)
  __nv_bfloat16* stage;  // this warp's tile buffers (H = kWideH: its warpgroup's)
  __nv_bfloat16 *feats, *vmean, *rmean;  // global scratch, one h-row each
  float* s_all;          // B9: each message's output scalar (global scratch)
  float proj_b;
  int Z, R, C, K, E, n, M;
};

// Chunk u (8 features) of the bf16 mean of group `row`: variable row (row <
// n) or check row - n, over its members in member order.
template <int H>
__device__ __forceinline__ void mean_chunk(const Block& b, int row, int u) {
  const int Z = b.Z;
  const Graph& g = b.g;
  float x[8];
  float inv;
  __nv_bfloat16* dst;
  if (row < b.n) {
    const int cc = row / Z, z = row - cc * Z;
    sum_members<H>(x, b.feats, u, g.col_ptr[cc], g.col_ptr[cc + 1],
                   [&](int j) { return g.col_edge[j] * Z + z; });
    inv = b.inv_dc[cc];
    dst = b.vmean + static_cast<size_t>(row) * H + u * 8;
  } else {
    const int rz = row - b.n, r = rz / Z, zc = rz - r * Z;
    sum_members<H>(x, b.feats, u, g.row_ptr[r], g.row_ptr[r + 1], [&](int j) {
      const int k = g.row_edge[j];
      const int v = zc + g.shift[k];
      return k * Z + (v >= Z ? v - Z : v);
    });
    inv = b.inv_dr[r];
    dst = b.rmean + static_cast<size_t>(rz) * H + u * 8;
  }
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = pack_bf16(__fmul_rn(x[2 * e], inv), __fmul_rn(x[2 * e + 1], inv));
  *reinterpret_cast<uint4*>(dst) = out;
}

// acc = 0 (the C fragments of an h-wide output).
template <int H>
__device__ __forceinline__ void zero(float (&acc)[H / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
}

// The A fragment of k-tile kt of a staged 16-row segment (rows of H + 8).
template <int H>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* seg, int kt,
                                       int lane) {
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  ldmatrix_x4(a, seg + arow * (H + 8) + kt * 16 + acol);
}

// acc += a . W^T over all H outputs for one 16-column k-tile of input: a the
// A fragment, W a padded [out][in] block in shared memory (rows of ws bf16),
// kcol the k-tile's first input column.
template <int H>
__device__ __forceinline__ void mma_ktile(float (&acc)[H / 8][4], const uint32_t (&a)[4],
                                          const __nv_bfloat16* W, int ws, int kcol, int lane) {
  const int brow = (lane >> 4) * 8 + (lane & 7), bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int p = 0; p < H / 16; ++p) {
    uint32_t w[4];
    ldmatrix_x4(w, W + (p * 16 + brow) * ws + kcol + bcol);
    mma_bf16(acc[2 * p], a, w[0], w[1]);
    mma_bf16(acc[2 * p + 1], a, w[2], w[3]);
  }
}

// acc[0..1] = a . W^T for outputs 16p .. 16p + 15 (n-tiles 2p, 2p + 1): a
// the A fragments of an h-wide input, W a padded [out][in] block (rows of ws
// bf16), kcol the input's first column in it.
template <int H>
__device__ __forceinline__ void product16(float (&acc)[2][4], const uint32_t (&a)[H / 16][4],
                                          const __nv_bfloat16* W, int ws, int kcol, int p,
                                          int lane) {
  const int brow = (lane >> 4) * 8 + (lane & 7), bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[0][i] = acc[1][i] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < H / 16; ++kt) {
    uint32_t w[4];
    ldmatrix_x4(w, W + (p * 16 + brow) * ws + kcol + kt * 16 + bcol);
    mma_bf16(acc[0], a[kt], w[0], w[1]);
    mma_bf16(acc[1], a[kt], w[2], w[3]);
  }
}

// acc = [F | Mean | lf] . W^T over one staged tile: F and Mean are staged
// segments (16 rows), lf the A fragments of the LLR features, W a padded
// (H x 2H, or 3H with injection) weight block in shared memory.
template <int H, bool INJ>
__device__ __forceinline__ void first_layer(float (&acc)[H / 8][4], const __nv_bfloat16* F,
                                            const __nv_bfloat16* Mean,
                                            const uint32_t (&lf)[H / 16][4],
                                            const __nv_bfloat16* W, int lane) {
  using S = Shape<H, INJ, 7>;
  zero<H>(acc);
#pragma unroll
  for (int seg = 0; seg < (INJ ? 3 : 2); ++seg) {
#pragma unroll
    for (int kt = 0; kt < S::KT; ++kt) {
      uint32_t a[4];
      if (seg < 2) {
        load_a<H>(a, seg == 0 ? F : Mean, kt, lane);
      } else {
        a[0] = lf[kt][0]; a[1] = lf[kt][1]; a[2] = lf[kt][2]; a[3] = lf[kt][3];
      }
      mma_ktile<H>(acc, a, W, S::WSV, seg * H + kt * 16, lane);
    }
  }
}

// The first layer's epilogue: plus the bias b1 (bias(rr, j): outputs j, j + 1
// of row g + 8 rr of the tile), relu, bf16, packed as the second layer's A
// fragments (k-tile p = output columns 16p .. 16p + 15).
template <int H, typename Bias>
__device__ __forceinline__ void relu_pack(const float (&acc)[H / 8][4], Bias&& bias, int tig,
                                          uint32_t (&h)[H / 16][4]) {
#pragma unroll
  for (int p = 0; p < H / 16; ++p) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nt = 2 * p + half, j = nt * 8 + 2 * tig;
      const float2 u = bias(0, j);
      const float2 v = bias(1, j);
      h[p][2 * half] = pack_bf16(fmaxf(__fadd_rn(acc[nt][0], u.x), 0.0f),
                                 fmaxf(__fadd_rn(acc[nt][1], u.y), 0.0f));
      h[p][2 * half + 1] = pack_bf16(fmaxf(__fadd_rn(acc[nt][2], v.x), 0.0f),
                                     fmaxf(__fadd_rn(acc[nt][3], v.y), 0.0f));
    }
  }
}

// acc += h . W2[:, side*H .. side*H + H)^T: one half of the second layer,
// W2 = [W2v W2c] a padded (H x 2H) block in shared memory.
template <int H>
__device__ __forceinline__ void second_half(float (&acc)[H / 8][4], const uint32_t (&h)[H / 16][4],
                                            const __nv_bfloat16* W2, int side, int lane) {
#pragma unroll
  for (int kt = 0; kt < H / 16; ++kt)
    mma_ktile<H>(acc, h[kt], W2, 2 * H + 8, side * H + kt * 16, lane);
}

// acc = [h1v | h1c] . [W2v W2c]^T, one float32 sum over both halves.
template <int H>
__device__ __forceinline__ void second_layer(float (&acc)[H / 8][4],
                                             const uint32_t (&h1v)[H / 16][4],
                                             const uint32_t (&h1c)[H / 16][4],
                                             const __nv_bfloat16* W2, int lane) {
  zero<H>(acc);
  second_half<H>(acc, h1v, W2, 0, lane);
  second_half<H>(acc, h1c, W2, 1, lane);
}

// B fragments of a thin (H-long) row as column 0 of a 16x8 B tile per k-tile:
// lanes 0..3 (g = 0) hold it, every other lane zeros (B4's thin product).
template <int H>
__device__ __forceinline__ void thin_frags(uint32_t (&w)[H / 16][2], const float* row, int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int kt = 0; kt < H / 16; ++kt) {
    const int q = kt * 16 + 2 * tig;
    w[kt][0] = lane < 4 ? pack_bf16(row[q], row[q + 1]) : 0u;
    w[kt][1] = lane < 4 ? pack_bf16(row[q + 8], row[q + 9]) : 0u;
  }
}

// s += a . row over an h-wide input (A fragments a), as a thin mma; s's
// column 0 (held by tig = 0: s[0] row g, s[2] row g + 8) is the product.
template <int H>
__device__ __forceinline__ void thin_product(float (&s)[4], const uint32_t (&a)[H / 16][4],
                                             const float* row, int lane) {
  uint32_t w[H / 16][2];
  thin_frags<H>(w, row, lane);
#pragma unroll
  for (int kt = 0; kt < H / 16; ++kt) mma_bf16(s, a[kt], w[kt][0], w[kt][1]);
}

// The lf A fragments (every k-tile) of a tile's rows g (LLR m0) and g + 8 (m1).
template <int H>
__device__ __forceinline__ void llr_frags(uint32_t (&lf)[H / 16][4], const Block& b, float m0,
                                          float m1, int tig) {
#pragma unroll
  for (int kt = 0; kt < H / 16; ++kt) {
    const int q = kt * 16 + 2 * tig;
    lf[kt][0] = embed2(m0, b.emb_w, b.emb_b, q);
    lf[kt][1] = embed2(m1, b.emb_w, b.emb_b, q);
    lf[kt][2] = embed2(m0, b.emb_w, b.emb_b, q + 8);
    lf[kt][3] = embed2(m1, b.emb_w, b.emb_b, q + 8);
  }
}

// ---------------------------------------------------------------------------
// B6, B7 and B9: message-major tiles
// ---------------------------------------------------------------------------

// Starts the copy of tile `tile`'s rows into `buf`: its messages' features,
// their variables' vmean rows and their checks' rmean rows (rows past the
// last message are zeros).  One commit group.
template <int H, bool INJ, int V>
__device__ __forceinline__ void load_tile(const Block& b, __nv_bfloat16* buf, int tile,
                                          int lane) {
  using S = Shape<H, INJ, V>;
  const int u = lane % S::CPR;
#pragma unroll
  for (int pass = 0; pass < kTile / S::RPP; ++pass) {
    const int r = lane / S::CPR + pass * S::RPP;
    const int i = tile * kTile + r;
    const bool valid = i < b.E;
    const int k = valid ? i / b.Z : 0;
    const int z = valid ? i - k * b.Z : 0;
    int zc = z - b.g.shift[k];
    zc = zc < 0 ? zc + b.Z : zc;
    const int dst = r * S::AS + u * 8;
    cp_async16(buf + dst, b.feats + static_cast<size_t>(valid ? i : 0) * H + u * 8, valid);
    cp_async16(buf + S::SEG + dst, b.vmean + static_cast<size_t>(b.g.col[k] * b.Z + z) * H + u * 8,
               valid);
    cp_async16(buf + 2 * S::SEG + dst,
               b.rmean + static_cast<size_t>(b.g.row[k] * b.Z + zc) * H + u * 8, valid);
  }
  cp_async_commit();
}

// The end of B9's last layer for one tile (rows i0 = g, i1 = g + 8 of this
// thread): s, which holds w2last . [h1v; h1c], plus proj8 . f after layer 0,
// to the scratch.
template <int H>
__device__ __forceinline__ void store_last(const Block& b, const __nv_bfloat16* F, float (&s)[4],
                                           int i0, int i1, bool residual, int lane) {
  if (residual) {
    uint32_t fa[H / 16][4];
#pragma unroll
    for (int kt = 0; kt < H / 16; ++kt) load_a<H>(fa[kt], F, kt, lane);
    thin_product<H>(s, fa, b.proj_w, lane);
  }
  if ((lane & 3) == 0) {
    if (i0 < b.E) b.s_all[i0] = s[0];
    if (i1 < b.E) b.s_all[i1] = s[2];
  }
}

// B9's last layer for one tile: no features, s = w2last . [h1v; h1c] (+
// proj8 . f after layer 0) per message, one float32 accumulation as a thin
// mma, to the scratch.
template <int H>
__device__ __forceinline__ void last_layer(const Args& a, const Block& b, const __nv_bfloat16* F,
                                           const uint32_t (&h1v)[H / 16][4],
                                           const uint32_t (&h1c)[H / 16][4], int i0, int i1,
                                           bool residual, int lane) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  thin_product<H>(s, h1v, a.extra, lane);
  thin_product<H>(s, h1c, a.extra + H, lane);
  store_last<H>(b, F, s, i0, i1, residual, lane);
}

// The epilogue of a message-major tile, in place: acc holds the second
// layer's product.  B7: f = bf16(acc + b2), plus the residual from layer 2
// on.  B6: f = bf16(out_v + bf16(acc + b2c)), out_v in ov, the same
// residual.  B9: out = bf16(acc + b2), d = bf16(dte[t + 1, k]); f = bf16(out
// + d) at t = 0, bf16(bf16(out + d) + f) after.  Then the tile's rows go to
// the scratch with 16-byte stores.
template <int H, bool INJ, int V>
__device__ __forceinline__ void write_tile(const Args& a, const Block& b, __nv_bfloat16* F,
                                           const float (&acc)[H / 8][4],
                                           const uint32_t (&ov)[H / 8][2], int tile, int t, int k0,
                                           int k1, int lane) {
  using S = Shape<H, INJ, V>;
  const int g = lane >> 2, tig = lane & 3;
  const bool residual = t >= 1;
  const float* b2 = b.small + (V == 7 ? 0 : V == 6 ? H : 2 * H);
  const float* dte = a.tab + static_cast<size_t>(t + 1) * b.K * H;
#pragma unroll
  for (int nt = 0; nt < S::NT; ++nt) {
    const int j = nt * 8 + 2 * tig;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      __nv_bfloat162* fp = reinterpret_cast<__nv_bfloat162*>(F + (g + 8 * rr) * S::AS + j);
      float o0 = bf16r(__fadd_rn(acc[nt][2 * rr], b2[j]));
      float o1 = bf16r(__fadd_rn(acc[nt][2 * rr + 1], b2[j + 1]));
      if constexpr (V == 6) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov[nt][rr]));
        o0 = bf16r(__fadd_rn(v.x, o0));
        o1 = bf16r(__fadd_rn(v.y, o1));
      }
      if constexpr (V == 9) {
        const float2 d = __ldg(reinterpret_cast<const float2*>(
            dte + static_cast<size_t>(rr ? k1 : k0) * H + j));
        o0 = __fadd_rn(o0, bf16r(d.x));
        o1 = __fadd_rn(o1, bf16r(d.y));
        if (residual) {
          o0 = bf16r(o0);
          o1 = bf16r(o1);
        }
      }
      if (residual) {
        const float2 old = __bfloat1622float2(*fp);
        o0 = __fadd_rn(o0, old.x);
        o1 = __fadd_rn(o1, old.y);
      }
      *fp = __floats2bfloat162_rn(o0, o1);
    }
  }
  __syncwarp();
  const int u = lane % S::CPR;
#pragma unroll
  for (int pass = 0; pass < kTile / S::RPP; ++pass) {
    const int r = lane / S::CPR + pass * S::RPP;
    const int i = tile * kTile + r;
    if (i < b.E)
      *reinterpret_cast<uint4*>(b.feats + static_cast<size_t>(i) * H + u * 8) =
          *reinterpret_cast<const uint4*>(F + r * S::AS + u * 8);
  }
}

// One staged tile of layer t: both MLPs, the residual (B9: and the delta),
// the features written back in place in `buf` and then to the scratch; B9's
// last layer writes each message's output scalar instead.
template <int H, bool INJ, int V>
__device__ __forceinline__ void compute_tile(const Args& a, const Block& b, __nv_bfloat16* buf,
                                             int tile, int t, int lane) {
  using S = Shape<H, INJ, V>;
  const int g = lane >> 2, tig = lane & 3;
  const int i0 = tile * kTile + g, i1 = i0 + 8;
  const int k0 = i0 < b.E ? i0 / b.Z : b.K - 1;
  const int k1 = i1 < b.E ? i1 / b.Z : b.K - 1;
  __nv_bfloat16* F = buf;

  uint32_t lf[H / 16][4];
  if constexpr (INJ) {
    const float m0 = i0 < b.E ? b.llr[b.g.col[k0] * b.Z + (i0 - k0 * b.Z)] : 0.0f;
    const float m1 = i1 < b.E ? b.llr[b.g.col[k1] * b.Z + (i1 - k1 * b.Z)] : 0.0f;
    llr_frags<H>(lf, b, m0, m1, tig);
  }

  // First-layer biases of outputs j, j + 1 of row g + 8 rr, b1v (side 0)
  // or b1c (side 1): B9's per layer, staged; B6's and B7's per edge (the
  // type embeddings folded in), from L2.
  const float* b1 = a.tab + static_cast<size_t>(t) * 2 * b.K * H;
  auto bias = [&](int side, int rr, int j) -> float2 {
    if constexpr (V == 9)
      return *reinterpret_cast<const float2*>(b.small + side * H + j);
    else
      return __ldg(reinterpret_cast<const float2*>(
          b1 + static_cast<size_t>(side * b.K + (rr ? k1 : k0)) * H + j));
  };
  const __nv_bfloat16* W1v = b.w;
  const __nv_bfloat16* W1c = b.w + H * S::WSV;
  const __nv_bfloat16* W2 = b.w + 2 * H * S::WSV;
  float acc[S::NT][4];
  uint32_t h1v[S::KT][4], h1c[S::KT][4];
  first_layer<H, INJ>(acc, F, buf + S::SEG, lf, W1v, lane);
  relu_pack<H>(acc, [&](int rr, int j) { return bias(0, rr, j); }, tig, h1v);
  first_layer<H, INJ>(acc, F, buf + 2 * S::SEG, lf, W1c, lane);
  relu_pack<H>(acc, [&](int rr, int j) { return bias(1, rr, j); }, tig, h1c);
  if constexpr (V == 9) {
    if (t == a.T - 1) {
      last_layer<H>(a, b, F, h1v, h1c, i0, i1, t >= 1, lane);
      return;
    }
  }

  // The second layer.  B6 rounds its halves apart: out_v = bf16(W2v h1v +
  // b2v) first, packed into registers h1v no longer needs, then W2c h1c in
  // the same accumulator; B7 and B9 sum both halves in one.
  uint32_t ov[S::NT][2];
  zero<H>(acc);
  second_half<H>(acc, h1v, W2, 0, lane);
  if constexpr (V == 6) {
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt) {
      const int j = nt * 8 + 2 * tig;
      const float2 b2v = *reinterpret_cast<const float2*>(b.small + j);
      ov[nt][0] = pack_bf16(__fadd_rn(acc[nt][0], b2v.x), __fadd_rn(acc[nt][1], b2v.y));
      ov[nt][1] = pack_bf16(__fadd_rn(acc[nt][2], b2v.x), __fadd_rn(acc[nt][3], b2v.y));
    }
    zero<H>(acc);
  }
  second_half<H>(acc, h1c, W2, 1, lane);
  write_tile<H, INJ, V>(a, b, F, acc, ov, tile, t, k0, k1, lane);
}

// Layer t of one frame, message-major: phase 1 (means; the weights stage
// meanwhile), phase 2 (message tiles).  Starts and ends with a barrier.
template <int H, bool INJ, int V>
__device__ void layer(const Args& a, const Block& b, int t) {
  using S = Shape<H, INJ, V>;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  const __nv_bfloat16* wl = a.w + static_cast<size_t>(t) * S::LW;
  for (int c = tid; c < S::LW / 8; c += nthreads) cp_async16(b.w + c * 8, wl + c * 8, true);
  cp_async_commit();
  for (int j = tid; j < small_floats(H, V); j += nthreads)
    b.small[j] = a.small[static_cast<size_t>(t) * small_floats(H, V) + j];

  // Phase 1: one 16-byte chunk of one variable's or check's mean a thread.
  for (int c = tid; c < (b.n + b.M) * S::CPR; c += nthreads)
    mean_chunk<H>(b, c / S::CPR, c % S::CPR);
  cp_async_wait<0>();
  __syncthreads();  // means, weights and biases visible to the whole block

  // Phase 2: 16-message tiles, a warp each, the next tile's rows in flight.
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int ntiles = (b.E + kTile - 1) / kTile;
  __nv_bfloat16* bufs[2] = {b.stage, b.stage + S::BUF};
  int cur = 0;
  if (warp < ntiles) load_tile<H, INJ, V>(b, bufs[0], warp, lane);
  for (int tile = warp; tile < ntiles; tile += nwarps) {
    const int next = tile + nwarps;
    if (next < ntiles) {
      load_tile<H, INJ, V>(b, bufs[cur ^ 1], next, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    compute_tile<H, INJ, V>(a, b, bufs[cur], tile, t, lane);
    __syncwarp();  // this buffer is read out before it is loaded again
    cur ^= 1;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// B7 and B9 at H = kWideH: warpgroup tiles on wgmma, the layer's weights
// streamed through a ring of chunk buffers
// ---------------------------------------------------------------------------

// Offset (elements) of entry (n, k) of an n x K bf16 matrix in core-matrix
// order, K-major: 8 x 8 blocks of 128 contiguous bytes (8 rows of 16 bytes),
// the blocks of an 8-row group along k, then the next group.  wgmma reads it
// with no swizzle: 128 bytes between blocks along k, K * 16 bytes between
// row groups; the 8 rows a block are 8 bank quads, so 16-byte accesses of
// one block never conflict.
__host__ __device__ constexpr int cm(int n, int k, int K) {
  return ((n >> 3) * (K >> 3) + (k >> 3)) * 64 + (n & 7) * 8 + (k & 7);
}

// The wgmma descriptor of k-tile kt of a core-matrix matrix of K columns at
// p (the start address, the byte strides along k and between row groups).
__device__ __forceinline__ uint64_t wg_desc(const __nv_bfloat16* p, int K, int kt) {
  return static_cast<uint64_t>((smem_addr(p + kt * 128) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) | (static_cast<uint64_t>(K * 16 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define WG_D4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// d (64 x 16) += A . B^T over one k-tile, A and B in shared memory.
__device__ __forceinline__ void wgmma_n16(float (&d)[2][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : WG_D4(0), WG_D4(1)
      : "l"(da), "l"(db));
}

// d (64 x 32) += A . B^T over one k-tile, A and B in shared memory.
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3)
      : "l"(da), "l"(db));
}

// d (64 x 128) += A . B^T over one k-tile, A from registers.
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5), WG_D4(6), WG_D4(7),
        WG_D4(8), WG_D4(9), WG_D4(10), WG_D4(11), WG_D4(12), WG_D4(13), WG_D4(14), WG_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef WG_D4

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Pins x in registers here: the compiler moves no access of x across this
// point, so none falls between an asynchronous wgmma and its wait.
template <int N>
__device__ __forceinline__ void wg_keep(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+f"(x[i][0]), "+f"(x[i][1]), "+f"(x[i][2]), "+f"(x[i][3])::"memory");
}

// Waits until the phase of `bar` with this parity has completed.  A wait
// that outlasts 2^26 polls (seconds; a chunk takes microseconds) traps, so a
// broken ring fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One bulk copy of `bytes` from global to shared, completing on `bar`, which
// expects those bytes (this thread's arrival included).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The 128 threads of warpgroup wg meet (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Starts the copy of this warp's 16 rows (rows0 .. rows0 + 15 of the
// warpgroup's tile `tile`) of the means into the tile buffer A (f, vmean,
// rmean of kWideRows messages, each kWideRows x H in core-matrix order):
// their variables' vmean rows and their checks' rmean rows; rows past the
// last message are zeros.  One commit group.
__device__ __forceinline__ void load_means_wide(const Block& b, __nv_bfloat16* A, int tile,
                                                int rows0, int lane) {
  constexpr int H = kWideH, MAT = kWideRows * kWideH;
  const int u = lane & 15;
#pragma unroll
  for (int pass = 0; pass < 8; ++pass) {
    const int r = rows0 + (lane >> 4) + 2 * pass;
    const int i = tile * kWideRows + r;
    const bool valid = i < b.E;
    const int k = valid ? i / b.Z : 0;
    const int z = valid ? i - k * b.Z : 0;
    int zc = z - b.g.shift[k];
    zc = zc < 0 ? zc + b.Z : zc;
    const int dst = cm(r, u * 8, H);
    cp_async16(A + MAT + dst,
               b.vmean + static_cast<size_t>(b.g.col[k] * b.Z + z) * H + u * 8, valid);
    cp_async16(A + 2 * MAT + dst,
               b.rmean + static_cast<size_t>(b.g.row[k] * b.Z + zc) * H + u * 8, valid);
  }
  cp_async_commit();
}

// The same for the rows' features, into A's first matrix.
__device__ __forceinline__ void load_feats_wide(const Block& b, __nv_bfloat16* A, int tile,
                                                int rows0, int lane) {
  constexpr int H = kWideH;
  const int u = lane & 15;
#pragma unroll
  for (int pass = 0; pass < 8; ++pass) {
    const int r = rows0 + (lane >> 4) + 2 * pass;
    const int i = tile * kWideRows + r;
    cp_async16(A + cm(r, u * 8, H), b.feats + static_cast<size_t>(i < b.E ? i : 0) * H + u * 8,
               i < b.E);
  }
  cp_async_commit();
}

// Phase 1 at H = kWideH: the bf16 means of kWideMeans (row, 16-byte chunk)
// items a thread at once (rows as in mean_chunk: variable row < n, else
// check row - n), their members' loads interleaved two members deep, so that
// eight loads are in flight where mean_chunk has four; each item's sum is
// mean_chunk's, in member order.  Four beat two (B7 309 against 322 ms at
// msg_gnn_main's shape at h = 128) and six (registers spill with injection).
constexpr int kWideMeans = 4;
__device__ __forceinline__ void means_wide(const Block& b, int tid, int nthreads) {
  constexpr int H = kWideH, CPR = H / 8, NB = kWideMeans;
  const int Z = b.Z, items = (b.n + b.M) * CPR;
  const Graph& g = b.g;
  for (int c0 = tid; c0 < items; c0 += NB * nthreads) {
    const int* list[NB];
    int j0[NB], deg[NB], zz[NB], u[NB], dmax = 0;
    bool check[NB];
    float x[NB][8];
    __nv_bfloat16* dst[NB];
    float inv[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int c = c0 + i * nthreads;
      const int row = c < items ? c / CPR : 0;
      u[i] = c - row * CPR;
      check[i] = row >= b.n;
      if (!check[i]) {
        const int cc = row / Z;
        zz[i] = row - cc * Z;
        list[i] = g.col_edge;
        j0[i] = g.col_ptr[cc];
        deg[i] = g.col_ptr[cc + 1] - j0[i];
        inv[i] = b.inv_dc[cc];
        dst[i] = b.vmean + static_cast<size_t>(row) * H + u[i] * 8;
      } else {
        const int rz = row - b.n, r = rz / Z;
        zz[i] = rz - r * Z;
        list[i] = g.row_edge;
        j0[i] = g.row_ptr[r];
        deg[i] = g.row_ptr[r + 1] - j0[i];
        inv[i] = b.inv_dr[r];
        dst[i] = b.rmean + static_cast<size_t>(rz) * H + u[i] * 8;
      }
      if (c >= items) deg[i] = 0;
      dmax = max(dmax, deg[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[i][e] = 0.0f;
    }
    auto load = [&](int i, int m) {
      const int k = list[i][j0[i] + m];
      int v = zz[i];
      if (check[i]) {
        v += g.shift[k];
        v = v >= Z ? v - Z : v;
      }
      return *reinterpret_cast<const uint4*>(b.feats + static_cast<size_t>(k * Z + v) * H +
                                             u[i] * 8);
    };
    for (int m = 0; m < dmax; m += 2) {
      uint4 v0[NB], v1[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        if (m < deg[i]) v0[i] = load(i, m);
        if (m + 1 < deg[i]) v1[i] = load(i, m + 1);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        if (m < deg[i]) add8(x[i], v0[i]);
        if (m + 1 < deg[i]) add8(x[i], v1[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (c0 + i * nthreads >= items) continue;
      uint4 out;
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = pack_bf16(__fmul_rn(x[i][2 * e], inv[i]), __fmul_rn(x[i][2 * e + 1], inv[i]));
      *reinterpret_cast<uint4*>(dst[i]) = out;
    }
  }
}

// The epilogue of a warpgroup tile at H = kWideH, this warp's rows first ..
// first + 15 (B7 and B9 as write_tile): acc plus b2 (B9: and the delta),
// plus the residual read from the scratch, written back there, each thread
// its own pairs of features.  The tile buffer already holds the next tile.
template <bool INJ, int V>
__device__ __forceinline__ void write_rows_wide(const Args& a, const Block& b,
                                                const float (&acc)[kWideH / 8][4], int first,
                                                int t, int k0, int k1, int lane) {
  constexpr int H = kWideH;
  const int g = lane >> 2, tig = lane & 3;
  const bool residual = t >= 1;
  const float* b2 = b.small + (V == 7 ? 0 : 2 * H);
  const float* dte = a.tab + static_cast<size_t>(t + 1) * b.K * H;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = first + g + 8 * rr;
    if (i >= b.E) continue;
    __nv_bfloat162* row = reinterpret_cast<__nv_bfloat162*>(b.feats + static_cast<size_t>(i) * H);
    __nv_bfloat162 old[H / 8];
    if (residual) {
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt) old[nt] = row[nt * 4 + tig];
    }
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      const int j = nt * 8 + 2 * tig;
      float o0 = bf16r(__fadd_rn(acc[nt][2 * rr], b2[j]));
      float o1 = bf16r(__fadd_rn(acc[nt][2 * rr + 1], b2[j + 1]));
      if constexpr (V == 9) {
        const float2 d = __ldg(reinterpret_cast<const float2*>(
            dte + static_cast<size_t>(rr ? k1 : k0) * H + j));
        o0 = __fadd_rn(o0, bf16r(d.x));
        o1 = __fadd_rn(o1, bf16r(d.y));
        if (residual) {
          o0 = bf16r(o0);
          o1 = bf16r(o1);
        }
      }
      if (residual) {
        const float2 f = __bfloat1622float2(old[nt]);
        o0 = __fadd_rn(o0, f.x);
        o1 = __fadd_rn(o1, f.y);
      }
      row[nt * 4 + tig] = __floats2bfloat162_rn(o0, o1);
    }
  }
}

// The products of chunk wc's first layer over the warpgroup's tile A,
// issued and committed (not waited for), in accumulators of their own so
// that the tensor cores overlap them: pf = f . [W1vf; W1cf]^T + lf . [W1vl;
// W1cl]^T (N = 32: the units' pv columns, then their pc columns; lf with
// injection), pm = vmean . W1va^T and pr = rmean . W1ca^T (N = 16 each), A
// and B from shared memory.  first_sums adds them.
template <bool INJ>
__device__ __forceinline__ void first_products(float (&pf)[4][4], float (&pm)[2][4],
                                               float (&pr)[2][4], const __nv_bfloat16* A,
                                               const __nv_bfloat16* wc) {
  constexpr int H = kWideH, CH = kWideChunk, MAT = kWideRows * kWideH;
  const __nv_bfloat16* Bf = wc;                 // [W1vf; W1cf], 2 CH x H
  const __nv_bfloat16* Bva = wc + 2 * CH * H;   // W1va, CH x H
  const __nv_bfloat16* Bca = Bva + CH * H;      // W1ca
  const __nv_bfloat16* Bl = Bca + CH * H;       // [W1vl; W1cl] (INJ)
  zero<2 * CH>(pf);
  zero<CH>(pm);
  zero<CH>(pr);
  wg_keep(pf);
  wg_keep(pm);
  wg_keep(pr);
  wg_fence();
#pragma unroll
  for (int kt = 0; kt < H / 16; ++kt) {
    wgmma_n32(pf, wg_desc(A, H, kt), wg_desc(Bf, H, kt));
    wgmma_n16(pm, wg_desc(A + MAT, H, kt), wg_desc(Bva, H, kt));
    wgmma_n16(pr, wg_desc(A + 2 * MAT, H, kt), wg_desc(Bca, H, kt));
    if constexpr (INJ) wgmma_n32(pf, wg_desc(A + 3 * MAT, H, kt), wg_desc(Bl, H, kt));
  }
  wg_commit();
}

// The first layer's outputs of first_products, bias b1 added in the plain
// version's order but for lf, whose product is inside pf: B7 (pf + mean) +
// b1 for both sides; B9 pv pf + (vmean + b1v), pc pf + (rmean + b1c).
// bias(rr, j): b1 of output j, j + 1 of row g + 8 rr (j < 16: pv's units,
// then pc's).  p as the C fragments of a 64 x 32 tile.
template <int V, typename Bias>
__device__ __forceinline__ void first_sums(float (&p)[4][4], const float (&pf)[4][4],
                                           const float (&pm)[2][4], const float (&pr)[2][4],
                                           Bias&& bias, int tig) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 bb = bias(i >> 1, nt * 8 + 2 * tig);
      const float b = (i & 1) ? bb.y : bb.x;
      const float m = nt >= 2 ? pr[nt - 2][i] : pm[nt][i];
      p[nt][i] = V == 9 ? __fadd_rn(pf[nt][i], __fadd_rn(m, b))
                        : __fadd_rn(__fadd_rn(pf[nt][i], m), b);
    }
  }
}

// Layer t of one frame at H = kWideH, message-major.
//   Phase 1: the means (means_wide); the ring's first chunks of the layer
//   load meanwhile.
//   Phase 2, in rounds: in round r warpgroup w takes tile r * kWideGroups +
//   w, kWideRows messages (each warp gathers its 16 rows; with injection it
//   also writes their lf rows), and walks the layer's chunks: it waits for
//   chunk c's full barrier, issues the chunk's first layer
//   (first_products; B7 loads its per-edge b1 from L2 meanwhile), waits for
//   it, adds the products and b1 (first_sums), packs relu into the A
//   registers of h1 = [h1v | h1c], issues acc += h1 . [W2v W2c]^T (two
//   m64n128k16 from registers) and waits for it, then releases the buffer;
//   or B9's last layer: s += thin products of h1.  After the last chunk's
//   first layer the warpgroup starts the next tile's rows.  No block barrier
//   a chunk: each warpgroup counts its release of a buffer, and the last
//   one to release it refills it with the chunk kWideStages on (one bulk
//   copy on its full barrier).  A warpgroup without a tile still waits and
//   releases.
// Every thread counts the ring's chunks in seq (the same in all), so the
// barriers' phase parities follow from it.  Starts and ends with a barrier.
template <bool INJ, int V>
__device__ void layer_wide(const Args& a, const Block& b, int t, uint64_t* bars, uint32_t& seq) {
  constexpr int H = kWideH, NCH = kWideH / kWideChunk, CW = chunk_weights(INJ);
  using S = Shape<H, INJ, V>;
  uint64_t* full = bars;
  unsigned long long* released = reinterpret_cast<unsigned long long*>(bars + kWideStages);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);  // warp-uniform to the compiler too
  const int ntiles = (b.E + kWideRows - 1) / kWideRows;
  const int steps = (ntiles + kWideGroups - 1) / kWideGroups * NCH;
  const __nv_bfloat16* wl = a.w + static_cast<size_t>(t) * S::LW;

  // Chunk step s of the layer (chunk s % NCH) into its ring buffer.
  auto fill = [&](int s) {
    const int st = (seq + s) % kWideStages;
    bulk_load(b.w + st * CW, wl + static_cast<size_t>(s % NCH) * CW, 2 * CW, &full[st]);
  };
  // This warpgroup is done with step s's buffer (its products on it have
  // retired in every warp); the last warpgroup to be refills it.
  auto release = [&](int s) {
    wg_sync(wg);
    if ((tid & 127) == 0) {
      const int st = (seq + s) % kWideStages;
      if (atomicAdd(&released[st], 1ull) % kWideGroups == kWideGroups - 1 &&
          s + kWideStages < steps) {
        __threadfence_block();
        fill(s + kWideStages);
      }
    }
    __syncwarp();
  };
  if (tid == 0)  // every buffer is free: the last layer released them all
    for (int s = 0; s < steps && s < kWideStages; ++s) fill(s);
  for (int j = tid; j < small_floats(H, V); j += nthreads)
    b.small[j] = a.small[static_cast<size_t>(t) * small_floats(H, V) + j];

  means_wide(b, tid, nthreads);  // phase 1
  __syncthreads();  // means and biases visible to the whole block

  const int rows0 = 16 * (warp & 3), g = lane >> 2, tig = lane & 3;
  __nv_bfloat16* A = b.stage;  // the warpgroup's tile buffer: f, vmean, rmean
  // This warp's A fragments of f in core-matrix order (B9's proj8 . f).
  const int arow = rows0 + (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  auto load_f = [&](uint32_t (&x)[4], int kt) { ldmatrix_x4(x, A + cm(arow, kt * 16 + acol, H)); };
  const bool last = V == 9 && t == a.T - 1;
  if (wg < ntiles) {
    load_means_wide(b, A, wg, rows0, lane);
    load_feats_wide(b, A, wg, rows0, lane);
  }
  for (int r = 0; r * NCH < steps; ++r) {
    const int tile = r * kWideGroups + wg;
    const bool has = tile < ntiles;
    const int i0 = tile * kWideRows + rows0 + g, i1 = i0 + 8;
    const int k0 = i0 < b.E ? i0 / b.Z : b.K - 1;
    const int k1 = i1 < b.E ? i1 / b.Z : b.K - 1;
    if constexpr (INJ) {  // lf of this thread's rows into the tile buffer's fourth matrix
      const float m0 = i0 < b.E ? b.llr[b.g.col[k0] * b.Z + (i0 - k0 * b.Z)] : 0.0f;
      const float m1 = i1 < b.E ? b.llr[b.g.col[k1] * b.Z + (i1 - k1 * b.Z)] : 0.0f;
      __nv_bfloat16* L = A + 3 * kWideRows * H;
#pragma unroll
      for (int q = 2 * tig; q < H; q += 8) {
        *reinterpret_cast<uint32_t*>(L + cm(rows0 + g, q, H)) = embed2(m0, b.emb_w, b.emb_b, q);
        *reinterpret_cast<uint32_t*>(L + cm(rows0 + g + 8, q, H)) =
            embed2(m1, b.emb_w, b.emb_b, q);
      }
    }
    float acc[S::NT][4];
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    zero<H>(acc);
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // rows, lf -> wgmma
    wg_sync(wg);  // the tile's 64 rows, every warp's, in place

    for (int c = 0; c < NCH; ++c) {
      const int step = r * NCH + c;
      const uint32_t q = seq + step;
      const int st = q % kWideStages;
      mbar_wait(&full[st], (q / kWideStages) & 1);
      if (!has) {
        release(step);
        continue;
      }
      const __nv_bfloat16* wc = b.w + st * CW;
      float pf[4][4], pm[2][4], pr[2][4];
      first_products<INJ>(pf, pm, pr, A, wc);
      // B9's last layer: s = proj8 . f first, while the buffer holds f.
      if (last && c == 0 && t >= 1) {
#pragma unroll
        for (int kt = 0; kt < H / 16; ++kt) {
          uint32_t x[1][4];
          load_f(x[0], kt);
          thin_product<16>(s, x, b.proj_w + kt * 16, lane);
        }
      }
      // b1v (nt < 2) or b1c of units u0 + nt % 2 * 8 + 2 tig, + 1, rows g
      // and g + 8: B7's per edge, from L2, loaded while the products run;
      // B9's per layer, staged.
      const int u0 = c * kWideChunk;
      auto bias = [&](int nt, int rr) -> float2 {
        const int side = nt >> 1, u = u0 + (nt & 1) * 8 + 2 * tig;
        if constexpr (V == 9)
          return *reinterpret_cast<const float2*>(b.small + side * H + u);
        else
          return __ldg(reinterpret_cast<const float2*>(
              a.tab + (static_cast<size_t>(t) * 2 * b.K + side * b.K + (rr ? k1 : k0)) * H + u));
      };
      float2 b1[4][2];
      if constexpr (V != 9) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) b1[nt][0] = bias(nt, 0), b1[nt][1] = bias(nt, 1);
      }
      wg_wait();
      wg_keep(pf);
      wg_keep(pm);
      wg_keep(pr);
      if (c == NCH - 1 && tile + kWideGroups < ntiles) {
        wg_sync(wg);  // every warp's products have read the tile: the next one's load
        load_means_wide(b, A, tile + kWideGroups, rows0, lane);
        load_feats_wide(b, A, tile + kWideGroups, rows0, lane);
      }
      float p[4][4];
      first_sums<V>(p, pf, pm, pr, [&](int rr, int j) {
        return V == 9 ? bias(j >> 3, rr) : b1[j >> 3][rr];
      }, tig);
      uint32_t h1[2][4];  // k-tile 0: h1v of the chunk's units, 1: h1c
      relu_pack<2 * kWideChunk>(p, [](int, int) { return make_float2(0.0f, 0.0f); }, tig, h1);
      if (last) {
        release(step);
        thin_product<kWideChunk>(s, *reinterpret_cast<const uint32_t(*)[1][4]>(h1[0]),
                                 a.extra + u0, lane);
        thin_product<kWideChunk>(s, *reinterpret_cast<const uint32_t(*)[1][4]>(h1[1]),
                                 a.extra + H + u0, lane);
      } else {
        const __nv_bfloat16* W2 = wc + (INJ ? 6 : 4) * kWideChunk * H;  // H x 2 CH
        wg_keep(acc);
        wg_fence();
        wgmma_n128_rs(acc, h1[0], wg_desc(W2, 2 * kWideChunk, 0));
        wgmma_n128_rs(acc, h1[1], wg_desc(W2, 2 * kWideChunk, 1));
        wg_commit();
        wg_wait();
        wg_keep(acc);
        release(step);
      }
    }
    if (has) {
      if (last)
        store_last<H>(b, A, s, i0, i1, false, lane);
      else
        write_rows_wide<INJ, V>(a, b, acc, tile * kWideRows + rows0, t, k0, k1, lane);
    }
  }
  seq += steps;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// B8: check-major tiles
// ---------------------------------------------------------------------------

// The next tile for this warp from the block's queue (lane 0 takes it, every
// lane gets it).
__device__ __forceinline__ int next_tile(int* queue, int lane) {
  int tile = 0;
  if (lane == 0) tile = atomicAdd(queue, 1);
  return __shfl_sync(0xffffffffu, tile, 0);
}

// A tile row: its base row, its lane zc, its first member slot and its
// degree (0: no row).
struct TileRow {
  int grp, z, j0, d;
};

__device__ __forceinline__ TileRow tile_row(const Block& b, int tile, int r) {
  TileRow t{0, 0, 0, 0};
  const int i = tile * kTile + r;
  if (i < b.M) {
    t.grp = i / b.Z;
    t.z = i - t.grp * b.Z;
    t.j0 = b.g.row_ptr[t.grp];
    t.d = b.g.row_ptr[t.grp + 1] - t.j0;
  }
  return t;
}

// Member slot s of a tile row: its base edge k and lane v = (zc + shift[k])
// mod Z, so its message is k*Z + v and its variable col[k]*Z + v; ok is
// false past the row's degree.
struct Member {
  int k, v;
  bool ok;
};

__device__ __forceinline__ Member member_of(const Block& b, const TileRow& r, int s) {
  Member m{0, 0, false};
  if (s < r.d) {
    m.k = b.g.row_edge[r.j0 + s];
    const int v = r.z + b.g.shift[m.k];
    m.v = v >= b.Z ? v - b.Z : v;
    m.ok = true;
  }
  return m;
}

// The largest degree of a tile's 16 rows (every lane gets it).
__device__ __forceinline__ int tile_degree(const Block& b, int tile, int lane) {
  return __reduce_max_sync(0xffffffffu, tile_row(b, tile, lane & 15).d);
}

// Starts the copy of stage st of tile `tile` (dmax its largest degree) into
// `buf`: st < dmax, the features of member slot st of every row; st >= dmax,
// the features and vmean rows of member slot st - dmax (zero rows where a
// row has no such member).  One commit group.
template <int H, bool INJ>
__device__ __forceinline__ void load_stage(const Block& b, __nv_bfloat16* buf, int tile, int st,
                                           int dmax, int lane) {
  using S = Shape<H, INJ, 8>;
  const bool update = st >= dmax;
  const int s = update ? st - dmax : st;
  const int u = lane % S::CPR;
#pragma unroll
  for (int pass = 0; pass < kTile / S::RPP; ++pass) {
    const int r = lane / S::CPR + pass * S::RPP;
    const Member m = member_of(b, tile_row(b, tile, r), s);
    const int dst = r * S::AS + u * 8;
    cp_async16(buf + dst, b.feats + static_cast<size_t>(m.k * b.Z + m.v) * H + u * 8, m.ok);
    if (update)
      cp_async16(buf + S::SEG + dst,
                 b.vmean + static_cast<size_t>(b.g.col[m.k] * b.Z + m.v) * H + u * 8, m.ok);
  }
  cp_async_commit();
}

// Update stage of member slot s of a tile (rows r0 = g, r1 = g + 8 of this
// thread): both MLPs with pre_row from registers, b2, the residual and the
// delta; the tile's rows written back in place in `buf`, then to the scratch.
template <int H, bool INJ>
__device__ __forceinline__ void update_members(const Block& b, __nv_bfloat16* buf,
                                               const float (&pre)[H / 8][4], const TileRow& r0,
                                               const TileRow& r1, int tile, int s, int t,
                                               int lane) {
  using S = Shape<H, INJ, 8>;
  const int g = lane >> 2, tig = lane & 3;
  const Member m0 = member_of(b, r0, s), m1 = member_of(b, r1, s);
  __nv_bfloat16* F = buf;
  const __nv_bfloat16* W1v = b.w;
  const __nv_bfloat16* W1c = W1v + H * S::WSV;
  const __nv_bfloat16* W2 = W1c + H * (S::WSC + S::WSA);
  const float* b1v = b.small;
  const float* b2 = b.small + 2 * H;

  uint32_t lf[H / 16][4];
  if constexpr (INJ)
    llr_frags<H>(lf, b, m0.ok ? b.llr[b.g.col[m0.k] * b.Z + m0.v] : 0.0f,
                 m1.ok ? b.llr[b.g.col[m1.k] * b.Z + m1.v] : 0.0f, tig);

  float acc[S::NT][4];
  uint32_t h1v[S::KT][4], h1c[S::KT][4];
  // pv = [f | vmean | lf] . W1v^T + b1v
  first_layer<H, INJ>(acc, F, buf + S::SEG, lf, W1v, lane);
  relu_pack<H>(acc, [&](int, int j) { return *reinterpret_cast<const float2*>(b1v + j); }, tig,
               h1v);
  // pc = ((W1cf f) + pre_row) + W1cl lf, 16 outputs at a time
  {
    uint32_t fa[S::KT][4];
#pragma unroll
    for (int kt = 0; kt < S::KT; ++kt) load_a<H>(fa[kt], F, kt, lane);
#pragma unroll
    for (int p = 0; p < S::KT; ++p) {
      float x[2][4];
      product16<H>(x, fa, W1c, S::WSC, 0, p, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 4; ++i) x[half][i] = __fadd_rn(x[half][i], pre[2 * p + half][i]);
      if constexpr (INJ) {
        float l[2][4];
        product16<H>(l, lf, W1c, S::WSC, H, p, lane);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int i = 0; i < 4; ++i) x[half][i] = __fadd_rn(x[half][i], l[half][i]);
      }
      h1c[p][0] = pack_bf16(fmaxf(x[0][0], 0.0f), fmaxf(x[0][1], 0.0f));
      h1c[p][1] = pack_bf16(fmaxf(x[0][2], 0.0f), fmaxf(x[0][3], 0.0f));
      h1c[p][2] = pack_bf16(fmaxf(x[1][0], 0.0f), fmaxf(x[1][1], 0.0f));
      h1c[p][3] = pack_bf16(fmaxf(x[1][2], 0.0f), fmaxf(x[1][3], 0.0f));
    }
  }
  second_layer<H>(acc, h1v, h1c, W2, lane);

  // Epilogue: out = bf16(acc + b2); f = bf16(out + d) at t = 0, else
  // bf16(bf16(out + f) + d); in place.
#pragma unroll
  for (int nt = 0; nt < S::NT; ++nt) {
    const int j = nt * 8 + 2 * tig;
    const float2 bb = *reinterpret_cast<const float2*>(b2 + j);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      __nv_bfloat162* fp = reinterpret_cast<__nv_bfloat162*>(F + (g + 8 * rr) * S::AS + j);
      const float2 d = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b.dte + (rr == 0 ? m0.k : m1.k) * H + j));
      float o0 = bf16r(__fadd_rn(acc[nt][2 * rr], bb.x));
      float o1 = bf16r(__fadd_rn(acc[nt][2 * rr + 1], bb.y));
      if (t >= 1) {
        const float2 old = __bfloat1622float2(*fp);
        o0 = bf16r(__fadd_rn(o0, old.x));
        o1 = bf16r(__fadd_rn(o1, old.y));
      }
      *fp = __floats2bfloat162_rn(__fadd_rn(o0, d.x), __fadd_rn(o1, d.y));
    }
  }
  __syncwarp();
  const int u = lane % S::CPR;
#pragma unroll
  for (int pass = 0; pass < kTile / S::RPP; ++pass) {
    const int r = lane / S::CPR + pass * S::RPP;
    const Member m = member_of(b, tile_row(b, tile, r), s);
    if (m.ok)
      *reinterpret_cast<uint4*>(b.feats + static_cast<size_t>(m.k * b.Z + m.v) * H + u * 8) =
          *reinterpret_cast<const uint4*>(F + r * S::AS + u * 8);
  }
}

// Phase 2 of B8's layer t for one warp: check tiles from `queue` until none
// is left.  Each tile runs dmax W1ca stages, then dmax update stages; the
// next stage's rows (at the tile's last, the next tile's first) load while
// a stage computes.
template <int H, bool INJ>
__device__ __forceinline__ void check_tiles(const Args& a, const Block& b, int t, int* queue) {
  using S = Shape<H, INJ, 8>;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int ntiles = (b.M + kTile - 1) / kTile;
  const __nv_bfloat16* W1ca = b.w + H * (S::WSV + S::WSC);
  const float* b1c = b.small + H;
  __nv_bfloat16* bufs[2] = {b.stage, b.stage + S::BUF};
  int cur = 0;
  int tile = next_tile(queue, lane);
  int dmax = tile < ntiles ? tile_degree(b, tile, lane) : 0;
  if (tile < ntiles) load_stage<H, INJ>(b, bufs[0], tile, 0, dmax, lane);
  while (tile < ntiles) {
    const int next = next_tile(queue, lane);
    const int dnext = next < ntiles ? tile_degree(b, next, lane) : 0;
    const TileRow r0 = tile_row(b, tile, g), r1 = tile_row(b, tile, g + 8);
    // Waits for stage st's rows, with the following stage's in flight.
    auto arrive = [&](int st) {
      if (st + 1 < 2 * dmax) {
        load_stage<H, INJ>(b, bufs[cur ^ 1], tile, st + 1, dmax, lane);
        cp_async_wait<1>();
      } else if (next < ntiles) {
        load_stage<H, INJ>(b, bufs[cur ^ 1], next, 0, dnext, lane);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
    };

    // pre_row = (sum over members of W1ca f) * (1 / degree) + b1c.
    float pre[S::NT][4];
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt) pre[nt][0] = pre[nt][1] = pre[nt][2] = pre[nt][3] = 0.0f;
    for (int s = 0; s < dmax; ++s) {
      arrive(s);
#pragma unroll
      for (int kt = 0; kt < S::KT; ++kt) {
        uint32_t fa[4];
        load_a<H>(fa, bufs[cur], kt, lane);
        mma_ktile<H>(pre, fa, W1ca, S::WSA, kt * 16, lane);
      }
      __syncwarp();  // this buffer is read out before it is loaded again
      cur ^= 1;
    }
    {
      const float inv0 = r0.d > 0 ? b.inv_dr[r0.grp] : 0.0f;
      const float inv1 = r1.d > 0 ? b.inv_dr[r1.grp] : 0.0f;
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(b1c + nt * 8 + 2 * tig);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pre[nt][i] = __fadd_rn(__fmul_rn(pre[nt][i], i < 2 ? inv0 : inv1), (i & 1) ? bv.y : bv.x);
      }
    }

    for (int s = 0; s < dmax; ++s) {
      arrive(dmax + s);
      update_members<H, INJ>(b, bufs[cur], pre, r0, r1, tile, s, t, lane);
      __syncwarp();
      cur ^= 1;
    }
    tile = next;
    dmax = dnext;
  }
}

// B8's layer t of one frame: phase 1 (variable means; the weights, biases
// and deltas stage meanwhile), phase 2 (check tiles).  Starts and ends with
// a barrier.
template <int H, bool INJ>
__device__ void layer_v3(const Args& a, const Block& b, int t, int* queue) {
  using S = Shape<H, INJ, 8>;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  const __nv_bfloat16* wl = a.w + static_cast<size_t>(t) * S::LW;
  for (int c = tid; c < S::LW / 8; c += nthreads) cp_async16(b.w + c * 8, wl + c * 8, true);
  cp_async_commit();
  for (int j = tid; j < 3 * H; j += nthreads)
    b.small[j] = a.small[static_cast<size_t>(t) * 3 * H + j];
  const float4* d = reinterpret_cast<const float4*>(a.tab + static_cast<size_t>(t + 1) * b.K * H);
  for (int i = tid; i < b.K * H / 4; i += nthreads) {
    const float4 x = __ldg(d + i);
    reinterpret_cast<uint2*>(b.dte)[i] = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
  if (tid == 0) *queue = 0;

  // Phase 1: one 16-byte chunk of one variable's mean a thread.
  for (int c = tid; c < b.n * S::CPR; c += nthreads) mean_chunk<H>(b, c / S::CPR, c % S::CPR);
  cp_async_wait<0>();
  __syncthreads();  // vmean, weights, biases, deltas and the queue visible to the whole block

  check_tiles<H, INJ>(a, b, t, queue);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The frame loop the four kernels share
// ---------------------------------------------------------------------------

template <int H, bool INJ, int V>
__device__ __forceinline__ void decode_frames(const Args& a) {
  using S = Shape<H, INJ, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_frame, s_queue;
  const int Z = a.Z, R = a.R, C = a.C, K = a.K;
  const int n = C * Z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const Layout L = make_layout(H, INJ, Z, R, C, K, nthreads / 32, V);

  int* s_graph = reinterpret_cast<int*>(smem + L.graph);
  float* s_inv = reinterpret_cast<float*>(smem + L.inv);
  float* s_emb = reinterpret_cast<float*>(smem + L.emb);
  for (int i = tid; i < 6 * K + R + C + 2; i += nthreads) s_graph[i] = a.graph[i];
  for (int i = tid; i < C + R; i += nthreads) s_inv[i] = a.inv[i];
  for (int i = tid; i < 3 * H + 1; i += nthreads) s_emb[i] = a.emb[i];

  Block b;
  b.g.row_ptr = s_graph;
  b.g.row_edge = b.g.row_ptr + R + 1;
  b.g.col_ptr = b.g.row_edge + K;
  b.g.col_edge = b.g.col_ptr + C + 1;
  b.g.shift = b.g.col_edge + K;
  b.g.col = b.g.shift + K;
  b.g.row = b.g.col + K;
  b.inv_dc = s_inv;
  b.inv_dr = s_inv + C;
  b.emb_w = s_emb;
  b.emb_b = s_emb + H;
  b.proj_w = s_emb + 2 * H;
  b.llr = reinterpret_cast<float*>(smem + L.llr);
  b.small = reinterpret_cast<float*>(smem + L.small);
  b.w = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  b.dte = reinterpret_cast<__nv_bfloat16*>(smem + L.dte);
  b.stage = reinterpret_cast<__nv_bfloat16*>(smem + L.stage) +
            (H == kWideH ? (tid >> 7) * wide_mats(INJ) * kWideRows * H : (tid >> 5) * 2 * S::BUF);
  b.feats = a.scratch + static_cast<size_t>(blockIdx.x) * scratch_elems(V, H, Z, R, C, K);
  b.vmean = b.feats + static_cast<size_t>(K) * Z * H;
  b.rmean = b.vmean + static_cast<size_t>(n) * H;
  b.s_all = reinterpret_cast<float*>(b.rmean + static_cast<size_t>(R) * Z * H);
  b.Z = Z;
  b.R = R;
  b.C = C;
  b.K = K;
  b.E = K * Z;
  b.n = n;
  b.M = R * Z;
  const Graph& g = b.g;
  // H = kWideH: the chunk ring's full barriers (one arrival and the bytes
  // of a fill), its release counts (one a warpgroup and chunk), and the
  // count of chunks it has carried.
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint32_t seq = 0;
  if constexpr (H == kWideH) {
    if (tid == 0) {
      for (int st = 0; st < kWideStages; ++st) {
        mbar_init(&bars[st], 1);
        bars[kWideStages + st] = 0;
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  b.proj_b = s_emb[3 * H];

  for (;;) {
    if (tid == 0) s_frame = atomicAdd(a.counter, 1);
    __syncthreads();
    const int f = s_frame;
    if (f >= a.B) break;
    const float* llr_f = a.llr + static_cast<size_t>(f) * n;
    float* soft_f = a.soft + static_cast<size_t>(f) * n;
    for (int i = tid; i < n; i += nthreads) b.llr[i] = llr_f[i];
    __syncthreads();

    // Seed: every message's features from its variable's LLR (B8, B9: plus
    // te_0, block 0 of the delta table), 8 a thread.
    for (int c = tid; c < b.E * S::CPR; c += nthreads) {
      const int i = c / S::CPR, u = c - i * S::CPR;
      const int k = i / Z, z = i - k * Z;
      const float m = b.llr[g.col[k] * Z + z];
      uint4 out;
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = u * 8 + 2 * e;
        if constexpr (folded(V)) {
          const float2 d = __ldg(reinterpret_cast<const float2*>(a.tab + k * H + q));
          o[e] = pack_bf16(__fadd_rn(__fadd_rn(__fmul_rn(m, b.emb_w[q]), b.emb_b[q]), d.x),
                           __fadd_rn(__fadd_rn(__fmul_rn(m, b.emb_w[q + 1]), b.emb_b[q + 1]), d.y));
        } else {
          o[e] = embed2(m, b.emb_w, b.emb_b, q);
        }
      }
      *reinterpret_cast<uint4*>(b.feats + static_cast<size_t>(i) * H + u * 8) = out;
    }
    __syncthreads();

    for (int t = 0; t < a.T; ++t) {
      if constexpr (check_major(V))
        layer_v3<H, INJ>(a, b, t, &s_queue);
      else if constexpr (H == kWideH)
        layer_wide<INJ, V>(a, b, t, bars, seq);
      else
        layer<H, INJ, V>(a, b, t);
    }

    // Output: per variable, the sum over its messages of their projection
    // plus proj_b (B9: of their output scalar plus dsc[k]), then the sigmoid
    // of the bit-1 logit.
    for (int i = tid; i < n; i += nthreads) {
      const int c = i / Z, z = i - c * Z;
      float acc = 0.0f;
      for (int j = g.col_ptr[c]; j < g.col_ptr[c + 1]; ++j) {
        const int k = g.col_edge[j];
        if constexpr (V == 9) {
          acc = __fadd_rn(__fadd_rn(acc, b.s_all[k * Z + z]), __ldg(a.extra + 2 * H + k));
        } else {
          const __nv_bfloat16* fk = b.feats + static_cast<size_t>(k * Z + z) * H;
          float contrib = 0.0f;
#pragma unroll
          for (int q = 0; q < H; q += 8) {
            const uint4 v = *reinterpret_cast<const uint4*>(fk + q);
            const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 x = __bfloat1622float2(p[e]);
              contrib = __fadd_rn(contrib, __fmul_rn(x.x, b.proj_w[q + 2 * e]));
              contrib = __fadd_rn(contrib, __fmul_rn(x.y, b.proj_w[q + 2 * e + 1]));
            }
          }
          acc = __fadd_rn(__fadd_rn(acc, contrib), b.proj_b);
        }
      }
      soft_f[i] = 1.0f / (1.0f + expf(__fadd_rn(b.llr[i], acc)));
    }
    __syncthreads();
  }
}

// B6, _kernel: message-major tiles, the type embeddings in per-edge biases,
// the second layer's halves rounded to bf16 apart.
template <int H, bool INJ>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) msg_gnn_tc_kernel(const Args a) {
  decode_frames<H, INJ, 6>(a);
}

// B7, _kernel_v2: message-major tiles, the type embeddings in per-edge biases.
template <int H, bool INJ>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) msg_gnn_v2_tc_kernel(const Args a) {
  decode_frames<H, INJ, 7>(a);
}

// B8, _kernel_v3: check-major tiles, the type embeddings in the features,
// pre_row in registers.
template <int H, bool INJ>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) msg_gnn_v3_tc_kernel(const Args a) {
  decode_frames<H, INJ, 8>(a);
}

// B9, _kernel_v4: message-major tiles, the type embeddings in the features,
// the last layer folded into thin rows through the output projection.
template <int H, bool INJ>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) msg_gnn_v4_tc_kernel(const Args a) {
  decode_frames<H, INJ, 9>(a);
}

// B7 and B9 at H = kWideH: warpgroup tiles on wgmma, the layer's weights
// streamed through a ring of chunks of kWideChunk hidden units.
template <bool INJ, int V>
__global__ void __launch_bounds__(kWideWarps * 32, 1) msg_gnn_wide_tc_kernel(const Args a) {
  decode_frames<kWideH, INJ, V>(a);
}

using KernelFn = void (*)(const Args);

template <int H, bool INJ>
KernelFn pick_variant(int V) {
  switch (V) {
    case 6: return msg_gnn_tc_kernel<H, INJ>;
    case 7: return msg_gnn_v2_tc_kernel<H, INJ>;
    case 8: return msg_gnn_v3_tc_kernel<H, INJ>;
    case 9: return msg_gnn_v4_tc_kernel<H, INJ>;
  }
  return nullptr;
}

template <bool INJ>
KernelFn pick_wide(int V) {
  switch (V) {
    case 7: return msg_gnn_wide_tc_kernel<INJ, 7>;
    case 9: return msg_gnn_wide_tc_kernel<INJ, 9>;
  }
  return nullptr;
}

KernelFn pick_kernel(int V, int H, int inject) {
  switch (H) {
    case 16: return inject ? pick_variant<16, true>(V) : pick_variant<16, false>(V);
    case 64: return inject ? pick_variant<64, true>(V) : pick_variant<64, false>(V);
    case kWideH: return inject ? pick_wide<true>(V) : pick_wide<false>(V);
  }
  return nullptr;
}

// The block shape: for each warp count 1..kMaxWarps the runtime's occupancy
// query; *warps, *blocks of the count with the most resident warps per SM
// (ties: the fewer warps a block).  H = kWideH has the one shape kWideWarps.
// Returns a cudaError_t; 0 blocks where not even one warp's block fits.
int plan_blocks(int V, int H, int inject, int Z, int R, int C, int K, int* warps, int* blocks) {
  *warps = 0;
  *blocks = 0;
  const KernelFn kernel = pick_kernel(V, H, inject);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  for (int w = H == kWideH ? kWideWarps : 1; w <= (H == kWideH ? kWideWarps : kMaxWarps); ++w) {
    const long long smem = make_layout(H, inject, Z, R, C, K, w, V).total;
    if (smem > optin) break;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * w, smem);
    if (err != cudaSuccess) return err;
    if (per_sm * w > *blocks * *warps) {
      *warps = w;
      *blocks = per_sm;
    }
  }
  return cudaSuccess;
}

// Launches variant V with `grid` blocks of `warps` warps on `stream`, no sync.
int launch(int V, int H, const void* llr, void* soft, void* counter, void* scratch,
           const void* graph, const void* inv, const void* w, const void* tab, const void* small,
           const void* emb, const void* extra, int B, int Z, int R, int C, int K, int T,
           int inject, int grid, int warps, void* stream) {
  const KernelFn kernel = pick_kernel(V, H, inject);
  if (kernel == nullptr || grid < 1 || B < 1 || T < 1 || warps < 1 || warps > kMaxWarps ||
      (H == kWideH && warps != kWideWarps))
    return cudaErrorInvalidValue;
  const long long smem = make_layout(H, inject, Z, R, C, K, warps, V).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  Args a;
  a.llr = static_cast<const float*>(llr);
  a.soft = static_cast<float*>(soft);
  a.counter = static_cast<int*>(counter);
  a.scratch = static_cast<__nv_bfloat16*>(scratch);
  a.graph = static_cast<const int*>(graph);
  a.inv = static_cast<const float*>(inv);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.tab = static_cast<const float*>(tab);
  a.small = static_cast<const float*>(small);
  a.emb = static_cast<const float*>(emb);
  a.extra = static_cast<const float*>(extra);
  a.B = B;
  a.Z = Z;
  a.R = R;
  a.C = C;
  a.K = K;
  a.T = T;
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Four entries per kernel, `name` its launch:
//   name_tc_smem_bytes: bytes of dynamic shared memory one block of `warps`
//     warps needs;
//   name_tc_scratch_floats: floats of global scratch one block needs;
//   name_tc_plan: the block shape (plan_blocks), a cudaError_t;
//   name: launches the kernel on `stream` with `grid` blocks of `warps` warps,
//     no sync; `counter` must hold 0, `extra` is read by B9 alone.  Returns a
//     cudaError_t.
#define LDPC_MSG_GNN_TC_ENTRIES(name, V)                                                        \
  long long name##_tc_smem_bytes(int H, int inject, int Z, int R, int C, int K, int warps) {     \
    return make_layout(H, inject, Z, R, C, K, warps, V).total;                                  \
  }                                                                                              \
  long long name##_tc_scratch_floats(int H, int Z, int R, int C, int K) {                        \
    return scratch_elems(V, H, Z, R, C, K) / 2;                                                  \
  }                                                                                              \
  int name##_tc_plan(int H, int inject, int Z, int R, int C, int K, int* warps, int* blocks) {   \
    return plan_blocks(V, H, inject, Z, R, C, K, warps, blocks);                                 \
  }                                                                                              \
  int name(int H, const void* llr, void* soft, void* counter, void* scratch, const void* graph,  \
           const void* inv, const void* w, const void* tab, const void* small, const void* emb,  \
           const void* extra, int B, int Z, int R, int C, int K, int T, int inject, int grid,    \
           int warps, void* stream) {                                                            \
    return launch(V, H, llr, soft, counter, scratch, graph, inv, w, tab, small, emb, extra, B,  \
                  Z, R, C, K, T, inject, grid, warps, stream);                                   \
  }

LDPC_MSG_GNN_TC_ENTRIES(ldpc_msg_gnn, 6)     // msg_gnn_tc_kernel (B6, _kernel)
LDPC_MSG_GNN_TC_ENTRIES(ldpc_msg_gnn_v2, 7)  // msg_gnn_v2_tc_kernel (B7, _kernel_v2)
LDPC_MSG_GNN_TC_ENTRIES(ldpc_msg_gnn_v3, 8)  // msg_gnn_v3_tc_kernel (B8, _kernel_v3)
LDPC_MSG_GNN_TC_ENTRIES(ldpc_msg_gnn_v4, 9)  // msg_gnn_v4_tc_kernel (B9, _kernel_v4)

const char* ldpc_msg_gnn_tc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
