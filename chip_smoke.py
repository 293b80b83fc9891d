"""Drive ldpc_tpu_torch on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  — the card's name and power limit (nvidia-smi); no card: exit 1.
2. build   — compile every CUDA source of the port with nvcc (sm_90a), one
             process per source, all started together; the
             main-path kernels' resident blocks per SM from the runtime
             (retire_zlane's, retire_zlane_layered's,
             retire_zlane_sumproduct's and retire_zlane_layered_sumproduct's
             with their plans at Z=384, retire_layered's,
             retire_sumproduct's and retire_layered_sumproduct's with their
             plans at Z=32), registers per kernel (the four layered kernels'
             and retire_sumproduct's registers and spills by name); each
             retiring kernel's shared-memory bytes from the library against
             the wrapper's, every plan;
             the tensor-core kernels' (msg_gnn, msg_gnn_v2, msg_gnn_v3,
             msg_gnn_v4, corrected_v2, corrected) block shapes (their
             occupancy plans)
             and registers a thread, and the
             HMMA and HGMMA (tensor-core: mma.sync and wgmma) instructions
             of each of their kernels in cuobjdump -sass (none without).
3. compare — each kernel against its plain PyTorch version on the card, for
             {minsum, sumproduct} x {flooding, layered} x {tracking,
             throughput mode, early exit}: make_fused_minsum (min-sum
             flooding on fused_retire, layered min-sum on retire_layered,
             sum-product flooding on retire_sumproduct, layered sum-product
             on retire_layered_sumproduct) at toy_4x8 Z=4,
             nr_2_0_4 Z=4 and nr_2_0_32 Z=24, 32 and 64 (batches that are not
             a multiple of the block's frames), make_fused_minsum_zlane
             (min-sum flooding on retire_zlane, layered min-sum on
             retire_zlane_layered, sum-product flooding on
             retire_zlane_sumproduct, layered sum-product on
             retire_zlane_layered_sumproduct) at nr_2_0_32 Z=384; the four
             Z=32 kernels and the four large-Z kernels at Z=384 and Z=256
             also at -2, 1 and 6 dB and on
             quantised LLRs with ties and exact zeros (-0.0 among them);
             all four schedules on codes with a row of 31 and of 58 members
             at Z=4 (the retiring kernels' 64-bit state word, the *_wide
             routes) and of 121 (their 128-bit word's limit, the *_w128
             routes; sum-product also identical to fused), the same rows at
             Z=8 on fused_zlane decoders (the large-Z kernels' 64-bit and
             128-bit words, every flag set and schedule, each case also
             identical to fused_zlane), min-sum flooding
             and layered sum-product on a row of 122 members at Z=4 (the
             fused kernel's) and at Z=8 (fused_zlane's: wider
             than the retiring kernels take; their launch counts), layered
             min-sum and both sum-product schedules
             on one with a row of 20 (the layered kernels' run-time loops
             for rows wider than their unrolled bodies, retire_sumproduct's
             phi parked in the c2v slots); plus the
             serving path against the tensor-op decode_min_sum.  Min-sum:
             bits and conv_iter identical.  Sum-product: bits agree on >=
             99.9% and conv_iter within 1 (logf/tanhf round differently from
             torch's), and every case of the four sum-product retiring
             kernels identical to the kernel it replaced (fused through
             _launch_fused, fused_zlane through _launch_zlane).
4. main    — the serving path at full width: nr_2_0_32, Z=32, batch 65536,
             20 iterations, 3 dB BPSK LLRs made on the card, through
             MinSumScaledDecoder(backend="auto") (with and without early
             stopping) and make_fused_minsum, all on fused_retire (launch
             counts); the whole batch held against the plain version, 0 bit
             errors, mean conv_iter in [2.9, 3.1].  The kernel timed in five
             rounds, each beside its throughput-mode and early-exit flags
             on the same batch (early exit's output identical), the median
             and every round printed; a torch.profiler trace of one decode
             (trace_main: device time and launches by kernel).
4b. layered — the layered min-sum serving path on the main path's batch
             through MinSumScaledDecoder(schedule="layered") and
             make_fused_minsum(schedule="layered"): retire_layered launched,
             no other kernel; the whole batch identical to the plain version
             (and in throughput mode), 0 bit errors, mean conv_iter printed.
             Timed in five rounds beside its throughput mode and the kernel
             it replaced (fused through _launch_fused, output identical),
             median and every round printed; each split of a frame's row
             groups over 1-3 warps timed (layered_parts); traced once in a
             process of its own (trace_layered).
4c. sumproduct — BeliefPropagationDecoder(early_stopping=False) and
             make_fused_bp at the main path's batch, 20 iterations:
             retire_sumproduct launched, no other kernel; the whole batch
             against the plain version at the sum-product bars (and in
             throughput mode) and identical to the fused kernel it replaced,
             0 bit errors, mean conv_iter printed.  Timed in five rounds
             beside its throughput mode and the replaced kernel (fused
             through _launch_fused), median and every round printed; bound
             (float32, int32 and the phi transcendentals at the
             special-function rate), plan and occupancy; traced once in a
             process of its own (trace_sumproduct).
4d. sumproduct_layered — layered sum-product through make_fused_minsum at
             the main path's batch: retire_layered_sumproduct launched, no
             other kernel; the whole batch against the plain version at the
             sum-product bars (and in throughput mode) and identical to the
             fused kernel it replaced (_launch_fused), 0 bit errors, mean
             conv_iter.  Five rounds beside its throughput mode and the
             replaced kernel, median and every round; each split of a
             frame's row groups over 1-3 warps; c2v in L2 slices instead
             (retire_zlane_layered_sumproduct at Z=32, its plan at each
             parts count, outputs identical); bp_bound_ms with the
             layered counts of fused_minsum.cu's header, plan, occupancy,
             ptxas.
5. z384    — bench.py section_z384: nr_2_0_32 Z=384, batch 512, 20
             iterations, 3 dB, no early stop, through
             MinSumScaledDecoder(backend="auto") (fused_zlane, whose
             min-sum flooding runs on retire_zlane) and
             make_fused_minsum_zlane: retire_zlane launched, no other kernel;
             the whole batch identical to the plain version, 0 bit errors,
             mean conv_iter printed.  Timed in five rounds beside its
             throughput mode and the kernel it replaced (fused_zlane through
             _launch_zlane, output identical), median and every round
             printed; traced once in a process of its own (trace_z384).
             What bounds it (split_probe): retire_zlane with one part (half
             the warps a frame), and at Z=240, where a whole frame fits a
             block, fused_retire beside retire_zlane (one frame per SM
             either way), outputs identical; the same cost of the L2 slice
             for retire_zlane_layered beside retire_layered at Z=256 and
             retire_zlane_sumproduct beside retire_sumproduct at Z=224
             (each also with the other's warps a frame), outputs identical.
5b. z384_layered — layered min-sum at Z=384 on the same batch through
             MinSumScaledDecoder(schedule="layered") and
             make_fused_minsum_zlane(schedule="layered"):
             retire_zlane_layered launched, no other kernel; the whole batch
             identical to the plain version (and in throughput mode) and to
             the replaced fused_zlane (_launch_zlane), 0 bit errors, mean
             conv_iter printed.  Five rounds beside its throughput mode and
             the replaced kernel, median and every round printed; every
             parts count, the plan, occupancy, ptxas registers and spills.
5c. z384_sumproduct — BeliefPropagationDecoder(early_stopping=False) and
             make_fused_minsum_zlane(mode="sumproduct") on the same batch:
             retire_zlane_sumproduct launched, no other kernel; the whole
             batch at the sum-product bars against the plain version (and
             in throughput mode) and identical to the replaced fused_zlane,
             0 bit errors, mean conv_iter.  Five rounds beside its
             throughput mode and the replaced kernel; every parts count,
             bp_bound_ms, plan, occupancy, ptxas.
5d. z384_sumproduct_layered — layered sum-product at Z=384 on the same
             batch through make_fused_minsum_zlane:
             retire_zlane_layered_sumproduct launched, no other kernel; the
             whole batch at the sum-product bars against the plain version
             (and in throughput mode) and identical to the replaced
             fused_zlane, 0 bit errors.  Five rounds beside its throughput
             mode, the replaced kernel and one frame group of two parts an
             SM (parts=2) against the plan's two groups of one part, median
             and every round; every parts count, bound, plan, occupancy,
             ptxas.
5e. wide_rows — IEEE 802.3an's (2048, 1723) shape: a (6, 32) array of
             Z=64 circulants, every cell, shift (r*c) mod 64 (rows of 32
             members), batch 65536, 20 iterations, alpha 0.75; the SNR steps
             from 4.0 dB by 0.5 dB to the first whose mean conv_iter (min-sum
             flooding) lies in [2, 8], each step printed.  All four schedules
             through make_fused_minsum (and MinSumScaledDecoder, both
             schedules, BeliefPropagationDecoder, make_fused_bp) on
             fused_retire_wide, retire_layered_wide, retire_sumproduct_wide
             and retire_layered_sumproduct_wide, no other kernel; the whole
             batch against the plain version (min-sum identical, sum-product
             at its bars; whether identical printed) and identical to fused
             through _launch_fused; five rounds of each beside fused, every
             median below fused's; bounds, plans, ptxas of the 64-bit
             instantiations, bit errors and mean conv_iter.
5f. widest_rows — J. L. Fan's array LDPC code ("Array codes as low-density
             parity-check codes", 2000) at p = Z = 67: a (4, 64) array of
             67 x 67 circulants, every cell, shift (r*c) mod 67 (rows of 64
             members, columns of 4, n = 4288, rate about 0.94, no 4-cycles),
             batch 49152, 20 iterations; the SNR steps from 6.0 dB by 0.5
             dB as wide_rows'.  The four schedules on fused_retire_w128,
             retire_layered_w128, retire_sumproduct_w128 and
             retire_layered_sumproduct_w128 (the 128-bit state word), each
             checked and timed as in wide_rows, ptxas of the 128-bit
             instantiations.
5g. zlane_wide — the two shapes at large Z, where a frame exceeds a block
             (fused would need 393 KB of shared memory for each) and auto
             takes fused_zlane: 802.3an's at Z=384 (shift (r*c) mod 384,
             rows of 32, n = 12288) on retire_zlane_wide,
             retire_zlane_layered_wide, retire_zlane_sumproduct_wide and
             retire_zlane_layered_sumproduct_wide, and the array shape at
             p = Z = 256 (rows of 64, n = 16384) on the four *_w128 forms of
             the same kernels; batch 512, 20 iterations, the SNR stepped
             from 6.0 and 7.5 dB by 0.25 dB until the mean conv_iter is in
             [2, 8].  Each checked as in wide_rows against the plain version
             and identical to fused_zlane (_launch_zlane), and timed in five
             rounds beside fused_zlane, its throughput mode and, where its
             plan takes the frame, B1's route on the same word (a "fused"
             decoder built past the fused kernel's memory check); plans and
             ptxas of the instantiations.
6. gnn_compare — the corrected-GNN kernels (corrected_v2, corrected)
             against their plain versions on perturbed seeded parameters:
             {input injection on, off} x {fixed T, early exit with
             conv_iter}, share_layers once, at toy_4x8 Z=4 h=16, nr_2_0_4
             Z=4 h=64 and nr_2_0_32 Z=32 h=64, T=2, odd batch sizes.  Bars:
             soft bits within 2e-2 on frames whose conv_iter agrees,
             decisions equal on >= 99.9% of bits, conv_iter equal on >= 99%
             of frames.  Then the noise floor at nr_2_0_32: kernel against
             plain version beside plain version on the card against itself
             on the CPU and against itself with its hidden units permuted,
             at 1 iteration (held within 1e-5, corrected within 1e-4: its
             three roundings after the second layer), 2 (within 2e-2)
             and 3 (measured: the iteration at which the two first differ
             and how the error grows; decisions held at every depth).
             corrected_v2 and corrected on the exact inputs of
             ops/msg_gnn_exact.py (every reordered sum exact): soft bits and
             conv_iter identical to the plain version (torch.equal), toy_4x8
             h=16, nr_2_0_4 and nr_2_0_32 h=64, injection, share_layers and
             early exit.
7. gnn_zero_init — untrained parameters: both kernels with early exit give
             the bits and conv_iter of the fused min-sum kernel (alpha 0.8),
             exactly, at nr_2_0_32 Z=32.
8. gnn_main — the flagship serving path at full width: nr_2_0_32 Z=32 h=64,
             trained checkpoints read from results/ by the port's own
             msgpack reader, batch 2048, 0 dB, early exit: T=10 and T=20
             through corrected_v2, T=10 through corrected; the counted
             launch's whole batch and 64 frames at -3 dB (where half the
             frames fail) against the plain version, stopped frames against
             the tensor-op syndrome check, the fixed-T kernel against the module's forward
             within 3e-2, and BER/FER on encoded random codewords.
             corrected_v2 (bench.py's corrected kernel) and corrected are
             timed in five rounds, corrected_v2 at T=10 and T=20 and
             corrected at T=10 interleaved, median and every round printed;
             corrected_v2 is traced once in a process of its own
             (trace_gnn).
8b. gnn_bench_nr_2_0_4 — bench.py section_corrected_gnn on the card:
             results/corrected_gnn_nr_2_0_4.msgpack, nr_2_0_4 Z=4 (tiles
             span columns and rows of different degree), T=5, h=64,
             injection, batch 4096, 3 dB, early exit: corrected_v2 in five
             rounds, the whole batch against the plain version at the
             gnn_compare bars.
9. nms_compare — the trained neural min-sum kernels against their plain
             version on perturbed parameters, each case through its route
             (one launch of that kernel, no other): every weight sharing,
             depth 0-3, alpha and offset shared and per iteration, at
             nr_2_0_4 Z=4 and nr_2_0_32 Z=12, 32 and 128 on neural_group
             (Z=128 in a slice form, the FIFO in L2 slices; also with the
             weights read from L2, staged where they fit, each slice form
             forced where it has a plan, and through the side door on
             fused_neural); depth 5 and 8 at Z=128 on neural_group's
             run-time-depth form; rows of 31 members on neural_group_wide
             (64-bit state word) and of 64 and 121 on neural_group_w128
             (128-bit), Z=4; and on fused_neural a row of 122 members at
             Z=4, which no state word holds.  Bits identical; each plan's
             shared-memory bytes and each slice's words equal to the
             wrapper's.
9b. nms_serve_shape — the serving entry point's neural min-sum decoder
             (nr_2_0_4 Z=4, T=5, depth 2, the committed checkpoint, batch
             4096, 0 dB): neural_group in five rounds beside fused_neural
             through the side door, both identical to the plain version.
10. nms_unit — unit weights (scalar w_ch 1, depth 0, alpha 1, offset 0)
             through their route (neural_group) against fused min-sum at
             alpha 1 without tracking: decisions equal on >= 99.99% of bits
             (the variable update adds in another order), the count printed.
11. nms_main — results/oms10_per_iter_nr_2_0_32.msgpack (T=10, depth 2, per
             iteration) at nr_2_0_32 Z=32, batch 65536 GF(2)-encoded random
             codewords, QPSK at -3 dB, on neural_group (one launch): BER
             within 5% of 8.89e-3 (results/README.md), the whole batch
             identical to the plain version, and so is fused_neural's
             through the side door.  Five rounds, neural_group beside
             fused_neural and beside its weights read from L2, every round
             and the medians printed; variants (depth 1, no taps, each with
             the replaced kernel beside it, and every split of a frame into
             parts, staged and from L2), the plan and ptxas registers and
             spills.
11b. nms_large — the codes neural_group took from fused_neural: nr_2_0_32
             at Z=128 (T=10, depth 2, per-iteration edge weights from
             perturbed_nms, batch 16384, QPSK at -3 dB on random codewords
             of nr_codewords), Z=384 (batch 5461: about the same edges a
             batch) and Z=32 at depth 4 (batch 65536).  Per shape: the whole
             batch identical to the plain version and to fused_neural
             through the side door; five rounds of neural_group beside
             fused_neural; the sweep of layouts, parts and frame groups a
             block; the plan, ptxas, bound; Z=128 traced in a process of its
             own (trace_nms_large).
11c. nms_wide — the codes fused_neural alone served before neural_group took
             rows of 28-121 members and depths past 4, at full width: T=10,
             per-iteration edge weights from perturbed_nms, QPSK on random
             codewords (encoder_from_H): wide_rows' code (rows of 32, Z=64,
             batch 65536, depth 2) on neural_group_wide, widest_rows' (Fan's
             array code at p = 67, rows of 64, batch 49152, depth 2) on
             neural_group_w128, nr_2_0_32 Z=32 at depth 6 (batch 65536) on
             neural_group's run-time-depth form; the SNR stepped by 0.25 dB
             until the route's BER is at most 1e-2, the BER printed.  Per
             shape: launched alone, the whole batch identical to the plain
             version and to fused_neural through the side door; five rounds
             of the route beside fused_neural; a sweep of layouts and parts;
             the plan, ptxas, bound.  ``--only nms_wide`` runs it alone.
12. msg_gnn_compare — the fully-neural kernels (msg_gnn_v2, msg_gnn,
             msg_gnn_v3, msg_gnn_v4) against their plain versions, T=2, h 16
             and 64, injection and
             share_layers, seeded parameters moved by 0.02 noise: soft bits
             within 3e-2, decisions identical where the plain version is
             confident (|p - 0.5| > 0.05).  All four on the exact inputs
             of ops/msg_gnn_exact.py (every sum they reorder exact in any
             order): identical to the plain version (torch.equal), toy_4x8
             h=16, nr_2_0_4 and nr_2_0_32 h=64, injection and share_layers;
             msg_gnn_v3 and msg_gnn_v4 also with nonzero type embeddings
             (EXACT_TE_CASES, T 2 and 3), which only their delta tables
             carry, and msg_gnn_v4 at T=1 (its thin last layer alone).  Then
             one T=3 model
             decoded to depth 1, 2, 3 beside the plain version's
             card-against-CPU difference (printed).
13. msg_gnn_main — bench.py section_msg_gnn at full width: nr_2_0_32 Z=32
             h=64, T=20, no injection, batch 2048, BPSK all-zero at 3 dB:
             first a T=2 model on the whole batch at the T=2 bar, then
             msg_gnn_v2 (as the bench serves it), msg_gnn, msg_gnn_v3 and
             msg_gnn_v4, each whole batch against the plain version:
             decisions equal on >= 99.9%; each also at depth 1.  Each is
             timed in five rounds, median and every round printed, and
             traced once in a process of its own (trace_msg_gnn: device
             time and launches by kernel; a second profiler session in one
             process recorded no kernel).
14. msg_gnn_wide — msg_gnn_v2 and msg_gnn_v4 at h=128 (msg_gnn_wide_tc_kernel,
             warpgroup tiles on wgmma, the weights streamed through a ring
             of chunks on mbarriers): against their plain versions
             at T=2 on nr_2_0_4 Z=4 and nr_2_0_32 Z=32, injection and
             share_layers, at msg_gnn_compare's bars, the wrapper's shared
             memory and scratch equal to the library's; identical on
             EXACT_WIDE_CASES (msg_gnn_v4 also at T=1).  The path: the ported
             tools/eval_ft_floor.py (ldpc_tpu_torch.tools.eval_ft_floor) at
             1 dB on the h=128 T=10 checkpoints, 62 batches of 4096 frames
             each, through msg_gnn_v2 (its main, as the JAX tool serves
             them) and through msg_gnn_v4 (its loop, error_counts, with the
             same seeds), each with its counts set to 0 before: FER and BER within 3 combined standard errors (counted
             on frame errors) of
             results/gnn_h128t10_ft_floor.json; both kernels on one batch
             against MessageGNNDecoder.forward: >= 99.9% of the module's
             confident decisions equal.  Times in five rounds at the path's
             shape (batch 4096) and msg_gnn_main's shape at h=128, with the
             plain version, bound, block shape, registers, spills and HMMA
             and HGMMA counts: both kernels on wgmma (HGMMA), msg_gnn_v2
             with no HMMA, msg_gnn_v4's HMMA its thin last layer's.
15. serve  — ldpc_tpu_torch.serve_trained_decoder with --model message_gnn
             and --model neural_minsum on the committed nr_2_0_4 checkpoints
             (defaults: batch 4096, 0 dB), BER/FER printed beside
             results/nr_2_0_4_comparison.json's; each launch counter moves
             (neural min-sum: the counter of its route, neural_group).
16. bench_gnn_kernel — python -m ldpc_tpu_torch.tools.bench_gnn_kernel at
             its defaults (nr_2_0_4 Z=4, h=64, T=5, injection, batch 2048) on
             the committed nr_2_0_4 checkpoints: the six fused variants
             (msg_gnn, _v2, _v3, _v4 on the message GNN, corrected and
             corrected_v2 on the corrected GNN) against the module's forward
             on the card: >= 99.9% of the module's confident decisions equal,
             each kernel launched; Mbit/s, MFU and max |diff| printed.
17. probe  — python -m ldpc_tpu_torch.tools.probe_agg_mxu at its defaults
             (nr_2_0_32 Z=32, h=64, L=10, 128 frames): variant vpu identical
             to the plain version, mxu within one bf16 step, both identical
             on integer-valued features (exact_features); microseconds per
             frame and iteration.
18. train  — the training path (ldpc_tpu_torch.training) and what it trains,
             served.  (a) the flagship fine-tune of results/README.md: the
             corrected GNN at T=10, h=64, injection, nr_2_0_32 Z=32, from
             corrected10_gnn_nr_2_0_32_ft3 through LDPCDecoderTrainer.
             load_model, bf16, Adam 3e-4 on the cosine schedule, grad_clip
             1.0, SNR uniform in [-4, -1] dB, random codewords, batch 64,
             20 updates in chunks of 10, with remat and again without:
             ms per update (CUDA events around each chunk), peak device
             memory, losses; the first loss equal within 1e-5 and the remat
             peak lower; one update traced in a child (trace_train: device
             time of the costliest kernels, busy share).  (b) resume, in a child with deterministic
             algorithms: 20 updates saved after 10, a fresh trainer loads
             the state and takes the other 10, parameters and losses
             identical.  (c) the fine-tuned weights through corrected_v2
             (B4), batch 2048 at 0 dB, against the module's forward: >=
             99.9% of its confident decisions (|p - 0.5| > 0.05) equal.
             (d) OMS(10, per-iteration) from results/ fine-tuned 20 Adam
             updates at batch 4096 (SNR [-4, -1], random codewords), served
             through neural_group (B3) on nms_main's batch: bits identical
             to the plain version.  (e) the node GNN
             (make_base_graph_gnn_decoder, T=5, depth 2) by train at the
             reference defaults (SGD, momentum 0.9, weight decay 1e-4, 2
             epochs over [-2, 0, 2, 4] dB, batch 256): losses finite, ms a
             step.  (f) ComparativeEvaluator at nr_2_0_32 Z=32, [-3, -2, -1]
             dB, batch 4096, 2 trials: fused min-sum (fused_retire, 20
             iterations, alpha 0.75) and BP (retire_sumproduct, 50), each
             launched twice a trial (counts, then avg_iterations), and the
             fine-tuned GNN; the fused min-sum's results equal those of the
             same evaluator with fused=False.  Kernel rows for B4, B3 and
             the two B1 kernels with this phase's launches.
18b. cli   — ldpc_tpu_torch.cli.main in this process: workflow (train,
             evaluate, compare, and visualize where matplotlib imports; the
             line says whether it ran) at nr_2_0_32 Z=32 on the tied neural
             min-sum, 2 epochs at batch 256, 2 SNRs, 2 trials, into a
             temporary directory; then compare on
             results/corrected10_gnn_nr_2_0_32_ft3.msgpack (T=10, h=64,
             random codewords, QPSK, -3 dB, batch 2048, 10 trials, no
             classical rows): 702,870 parameters, BER and FER within 3
             combined binomial standard errors (counted on frame errors) of
             results/nr_2_0_32_corrected10_ft3_highprecision.json.
18c. parallel — ldpc_tpu_torch.parallel in child processes, the world set
             up in their environment: an NCCL world of 1, then two gloo
             ranks sharing the card.  Each rank: shard_decode over
             make_fused_minsum (fused_retire) at nr_2_0_32 Z=32, batch
             65536, 20 iterations, 3 dB, bits and conv_iter identical to the
             unsharded call, both timed (host clock around a synchronised
             call); mc_sweep(mesh=...) over that decoder identical to the
             unsharded sweep; the data-parallel Adam step on the tied
             decoder (batch 256) within 1e-5 of the 1-rank step's losses and
             parameters; fused_retire's launches per path.
18d. waterfall — ldpc_tpu_torch.tools.high_precision_curve at its defaults
             (1e9 bits a point, batch 65536, 20 iterations, 7 SNRs, 63 calls
             of fused_retire in throughput mode): every point's BER and FER
             within 3 combined binomial standard errors of
             results/nr_2_0_32_minsum_highprecision.json; wall seconds and
             decoded bits/s.
19. kernels — per kernel: launches in its path's run (fused and fused_zlane:
             the wide-row compare cases'; the *_wide kernels: wide_rows';
             the *_w128 kernels: widest_rows'; the retire_zlane*_wide and
             *_w128 kernels: zlane_wide's;
             neural_group a row for nms_main and one for each nms_large
             shape; neural_group_wide, neural_group_w128 and neural_group's
             run-time-depth form a row each for nms_wide's shapes;
             fused_neural nms_compare's routed case (a row of 122
             members), timed at nms_large's Z=128 through the side door),
             max abs error against
             the plain version, kernel / plain time, and the bound: the
             operations the batch's frames need (over their conv_iter
             iterations where they stop early), or its bytes, whichever
             takes longer on the card.

The line before the last is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
The replaced kernels' times (PERF.md §5) come from this script run from an
unpacked ``git archive`` of the parent commit, in the same call.
``--only PART [PART ...]`` (classical, wide, gnn, nms, nms_wide, msg_gnn,
tools, train, cli, parallel, waterfall) runs the build and those parts alone
(for development; the kernels line then lists those parts; ``wide`` is phase
3's wide-row cases and phases 5e to 5g, ``nms`` phases 9 to 11b,
``nms_wide`` phase 11c, ``msg_gnn`` phases 12 to 14, ``tools`` phases 16 and
17, ``train`` phase 18, ``cli``, ``parallel`` and ``waterfall`` phases 18b to
18d; each part prints its seconds).
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ldpc_tpu_torch.utils.profiling import (PEAK_BF16_TENSOR_OPS, PEAK_BYTES, PEAK_F32_OPS,
                                            PEAK_I32_OPS)

# Operations one min-sum iteration (flooding, convergence tracked) of one
# frame needs, whatever the kernel does; derived in the header of
# ldpc_tpu_torch/ops/csrc/fused_minsum.cu.  (float32, int32) per lifted edge,
# per lifted check and per variable.
OPS_PER_EDGE = (9, 1)
OPS_PER_CHECK = (4, 1)
OPS_PER_VAR = (2, 0)
# The layered schedule folds each new c2v into the belief at once
# ((belief + new) - old: two adds where flooding's column sum has one) and
# has no column sum, so a variable needs its hard decision alone.
OPS_PER_EDGE_LAYERED = (10, 1)
OPS_PER_VAR_LAYERED = (1, 0)
# Sum-product flooding (counted in the same header): per lifted edge 16
# float32, 1 int32 and 4 special-function operations (tanh and log of the
# two phi); per lifted check 1 int32; per variable 2 float32.  The special
# functions run on 16 units an SM and clock against 128 float32 lanes.
OPS_PER_EDGE_SUMPRODUCT = (16, 1, 4)
OPS_PER_CHECK_SUMPRODUCT = (0, 1, 0)
OPS_PER_VAR_SUMPRODUCT = (2, 0, 0)
# Layered sum-product (the same header): flooding's per-edge work less the
# column-sum add, plus the fold (belief + new) - old, two adds: 17 float32;
# a variable needs its hard decision alone, as layered min-sum.
OPS_PER_EDGE_SUMPRODUCT_LAYERED = (17, 1, 4)
OPS_PER_VAR_SUMPRODUCT_LAYERED = (1, 0, 0)
PEAK_SFU_OPS = PEAK_F32_OPS / 8


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int):
    """(mean device time of fn() over reps calls after one warm-up call,
    the last call's result)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound_ms(qc, conv: torch.Tensor, layered: bool = False) -> tuple[float, str]:
    """Least time for this batch's min-sum decode: LLRs read and bits +
    conv_iter written once, against the operations of the iterations each
    frame needs (its conv_iter: later ones change neither its frozen bits nor
    conv_iter)."""
    B, n = conv.shape[0], qc.num_vars
    frame_iterations = int(conv.sum().item())
    counts = (qc.num_edges, qc.num_base_rows * qc.Z, n)
    per_item = ((OPS_PER_EDGE_LAYERED, OPS_PER_CHECK, OPS_PER_VAR_LAYERED) if layered
                else (OPS_PER_EDGE, OPS_PER_CHECK, OPS_PER_VAR))
    f32, i32 = (sum(c * per[i] for c, per in zip(counts, per_item)) * frame_iterations
                for i in (0, 1))
    t_ops = (f32 / PEAK_F32_OPS + i32 / PEAK_I32_OPS) * 1e3
    t_bytes = (B * n * 4 * 2 + B * 4) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bp_bound_ms(qc, conv: torch.Tensor, layered: bool = False) -> tuple[float, str]:
    """bound_ms for sum-product, flooding or ``layered``: the float32, int32
    and special-function operations of each frame's conv_iter iterations,
    each at its rate, against the LLRs read and bits and conv_iter written."""
    B, n = conv.shape[0], qc.num_vars
    frame_iterations = int(conv.sum().item())
    counts = (qc.num_edges, qc.num_base_rows * qc.Z, n)
    per_item = ((OPS_PER_EDGE_SUMPRODUCT_LAYERED, OPS_PER_CHECK_SUMPRODUCT,
                 OPS_PER_VAR_SUMPRODUCT_LAYERED) if layered
                else (OPS_PER_EDGE_SUMPRODUCT, OPS_PER_CHECK_SUMPRODUCT, OPS_PER_VAR_SUMPRODUCT))
    f32, i32, sfu = (sum(c * per[i] for c, per in zip(counts, per_item)) * frame_iterations
                     for i in (0, 1, 2))
    t_ops = (f32 / PEAK_F32_OPS + i32 / PEAK_I32_OPS + sfu / PEAK_SFU_OPS) * 1e3
    t_bytes = (B * n * 4 * 2 + B * 4) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_of(stem: str, kernel: str, width: int = 12) -> dict:
    """Registers a thread and spill bytes of each instantiation of
    ``kernel`` in the compiler's report for ``stem``, keyed by the first
    ``width`` characters of its mangled template arguments."""
    from ldpc_tpu_torch.ops import _build

    out, name = {}, None
    for line in _build.build_log(stem).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and "spill stores" in line:
            out[name] = {"spill_bytes": [int(w) for w in line.replace(",", "").split()
                                         if w.isdigit()][1:3]}
        elif name and "registers" in line:
            out[name]["registers"] = int(line.split("Used ")[1].split()[0])
    return {k.split(kernel)[1][:width]: v for k, v in out.items()}


def trace_split(fn, name: str) -> dict:
    """One call of ``fn`` under ``utils.profiling.trace`` (the trace is written
    to build/traces/<name>/): device time and launches of each kernel, and
    the wall time of the call, synchronised.  Only the card's events count:
    the PyTorch operator that launched a kernel carries its device time too."""
    from ldpc_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with profiling.trace(Path(__file__).resolve().parent / "build" / "traces" / name) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {e.key: {"device_ms": e.self_device_time_total / 1e3, "launches": e.count}
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}
    return {"wall_ms": wall_ms, "device_ms": sum(k["device_ms"] for k in kernels.values()),
            "kernels": kernels}


# bench.py section_z384 (bench.py:383-405): nr_2_0_32 Z=384, batch 512, 3 dB.
Z384 = dict(B=512, SNR=3.0, llr_seed=3)


def trace_z384() -> dict:
    """One retire_zlane decode of the z384 batch under the profiler."""
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_minsum as fm

    qc = qc_layout(get_base_graph("nr_2_0_32"), 384)
    llr = llrs(qc.num_vars, Z384["B"], Z384["SNR"], seed=Z384["llr_seed"])
    dec = fm.make_fused_minsum_zlane(qc, 20, 0.75)
    dec(llr)  # warm-up: the plan and the first launch
    return {"phase": "trace_z384", "kernel": "retire_zlane", "batch": Z384["B"],
            **trace_split(lambda: dec(llr), "z384")}


# The main path's batch: nr_2_0_32 Z=32, 65536 frames, 3 dB (bench.py
# section_minsum); the layered and sum-product phases take it too.
MAIN = dict(B=65536, SNR=3.0, llr_seed=0)


def trace_layered() -> dict:
    """One retire_layered decode of the main path's batch under the profiler."""
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_minsum as fm

    qc = qc_layout(get_base_graph("nr_2_0_32"), 32)
    llr = llrs(qc.num_vars, MAIN["B"], MAIN["SNR"], seed=MAIN["llr_seed"])
    dec = fm.make_fused_minsum(qc, 20, 0.75, schedule="layered")
    dec(llr)  # warm-up: the plan and the first launch
    return {"phase": "trace_layered", "kernel": "retire_layered", "batch": MAIN["B"],
            **trace_split(lambda: dec(llr), "layered")}


def trace_sumproduct() -> dict:
    """One retire_sumproduct decode of the main path's batch under the
    profiler."""
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_minsum as fm

    qc = qc_layout(get_base_graph("nr_2_0_32"), 32)
    llr = llrs(qc.num_vars, MAIN["B"], MAIN["SNR"], seed=MAIN["llr_seed"])
    dec = fm.make_fused_bp(qc, 20)
    dec(llr)  # warm-up: the plan and the first launch
    return {"phase": "trace_sumproduct", "kernel": "retire_sumproduct", "batch": MAIN["B"],
            **trace_split(lambda: dec(llr), "sumproduct")}


# The retiring kernels of sum-product, each identical to the kernel it
# replaced (same_as_replaced).
SUMPRODUCT_ROUTES = ("retire_sumproduct", "retire_zlane_sumproduct", "retire_layered_sumproduct",
                     "retire_zlane_layered_sumproduct")


def same_as_replaced(dec, llr: torch.Tensor, label: str) -> None:
    """A retiring decoder's output identical (bits and conv_iter) to the
    kernel it replaced on the same input (fused through _launch_fused on a
    fused decoder, fused_zlane through _launch_zlane on a fused_zlane
    decoder): for sum-product (SUMPRODUCT_ROUTES and their wider words) the
    same float operations in the same order; for min-sum both equal the
    plain version."""
    old, replaced = ((dec._launch_fused, "fused") if dec.kind == "fused"
                     else (dec._launch_zlane, "fused_zlane"))
    (bits_k, conv_k), (bits_f, conv_f) = dec(llr), old(llr)
    torch.cuda.synchronize()
    ok = bool(torch.equal(bits_k, bits_f)) and bool(torch.equal(conv_k, conv_f))
    emit({"phase": "compare", "case": f"{label} against {replaced}", "identical": ok, "ok": ok})
    if not ok:
        raise AssertionError(f"{dec.route} differs from the {replaced} kernel: {label}")


def split_probe(zdec, llr384: torch.Tensor, iterations: int) -> dict:
    """What bounds retire_zlane: its time at Z=384 with one part (half the
    warps a frame), and at Z=240, where a whole frame still fits a block
    (one frame of 32 warps per SM either way), fused_retire (state words
    and LLRs in shared memory) beside retire_zlane (state words in the L2
    slice, LLRs from the input rows) on one batch, tracked and in
    throughput mode; outputs identical."""
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_minsum as fm

    out = {"z384_parts": {p: cuda_ms(lambda p=p: zdec._launch_retire(llr384, parts=p), reps=5)[0]
                          for p in fm.retire_zlane_plans(zdec.qc)}}
    qc = qc_layout(get_base_graph("nr_2_0_32"), 240)
    llr = llrs(qc.num_vars, 1056, 3.0, seed=5)
    for track in (True, False):
        # make_fused_minsum refuses Z=240 (the fused kernel's frame does not
        # fit), so the fused_retire decoder is built directly.
        whole = fm.FusedDecoder("fused", qc, iterations, 0.75, 1, "minsum", track, False,
                                "flooding", llr.device)
        split = fm.make_fused_minsum_zlane(qc, iterations, 0.75, track_convergence=track)
        assert (whole.route, split.route) == ("fused_retire", "retire_zlane")
        a, b = whole(llr), split(llr)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError("fused_retire and retire_zlane differ at Z=240")
        out[f"z240_B1056_{'tracked' if track else 'throughput_mode'}"] = {
            "plans": {"fused_retire": fm.retire_plan(qc, track)[:2],
                      "retire_zlane": fm.retire_zlane_plan(qc, track)[:1]},
            "fused_retire_ms": cuda_ms(lambda: whole(llr), reps=5)[0],
            "retire_zlane_ms": cuda_ms(lambda: split(llr), reps=5)[0]}
    # The same for the two large-Z kernels of the layered and sum-product
    # paths, each at a Z where the whole frame of the kernel beside it still
    # fits a block: layered min-sum at Z=256 (retire_layered, 184,144 bytes a
    # frame) and sum-product flooding at Z=224 (retire_sumproduct, 223,104).
    # "same_parts": the large-Z kernel with the warps a frame of the other.
    for Z, mode, schedule in ((256, "minsum", "layered"), (224, "sumproduct", "flooding")):
        qc = qc_layout(get_base_graph("nr_2_0_32"), Z)
        llr = llrs(qc.num_vars, 1056, 3.0, seed=Z)
        alpha = 0.75 if mode == "minsum" else 1.0
        whole = fm.FusedDecoder("fused", qc, iterations, alpha, 1, mode, True, False, schedule,
                                llr.device)
        split = fm.make_fused_minsum_zlane(qc, iterations, alpha, mode=mode, schedule=schedule)
        assert (whole.route, split.route) in (("retire_layered", "retire_zlane_layered"),
                                              ("retire_sumproduct", "retire_zlane_sumproduct"))
        parts = (fm.retire_layered_plan(qc, True) if mode == "minsum"
                 else fm.retire_sumproduct_plan(qc, True))[0]
        runs = {whole.route: lambda: whole(llr), split.route: lambda: split(llr),
                f"{split.route}_same_parts": functools.partial(split._launch_retire, llr,
                                                               parts=parts)}
        outs = {name: fn() for name, fn in runs.items()}
        ref = outs[whole.route]
        if not all(torch.equal(o[0], ref[0]) and torch.equal(o[1], ref[1]) for o in outs.values()):
            raise AssertionError(f"{whole.route} and {split.route} differ at Z={Z}")
        out[f"z{Z}_B1056_{schedule}_{mode}"] = {
            "plans": {whole.route: (fm.retire_layered_plan(qc, True) if mode == "minsum"
                                    else fm.retire_sumproduct_plan(qc, True))[:-1],
                      split.route: (fm.retire_zlane_layered_plan(qc, True) if mode == "minsum"
                                    else fm.retire_zlane_sumproduct_plan(qc, True))},
            **{f"{name}_ms": cuda_ms(fn, reps=5)[0] for name, fn in runs.items()}}
    return out


def wide_row_code(members: int = 31, Z: int = 4):
    """A (4, max(32, members + 2)) base graph at ``Z`` whose first row has
    ``members`` members: 20 is more than the layered kernels' unrolled rows
    take, 31 and 58 more than the retiring kernels' 32-bit state word holds
    signs of (their 64-bit word takes up to 58), 59 and 121 more than that
    (their 128-bit word takes up to 121), 122 more than any.  Every column
    has a member."""
    import numpy as np
    from ldpc_tpu_torch.codes import BaseGraph, qc_layout

    cols = 32 if members < 32 else members + 2
    rng = np.random.default_rng(3)
    shifts = np.where(rng.random((4, cols)) < 0.4, rng.integers(0, 4, (4, cols)), -1)
    shifts[0] = np.concatenate([rng.integers(0, 4, members), np.full(cols - members, -1)])
    shifts[1, members:] = 1
    return qc_layout(BaseGraph("wide", shifts), Z)


# The four B1 schedules, each with its 64-bit-word route (fm.WIDE_ROUTES) and
# its 128-bit-word route (fm.W128_ROUTES).
WIDE_SCHEDULES = (("minsum", "flooding"), ("minsum", "layered"), ("sumproduct", "flooding"),
                  ("sumproduct", "layered"))


def llrs(n: int, B: int, snr_db: float, seed: int) -> torch.Tensor:
    from ldpc_tpu_torch.utils import bpsk_awgn_llr

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return bpsk_awgn_llr(gen, torch.zeros((B, n), device="cuda"), snr_db)


def compare(dec, llr: torch.Tensor, label: str, plain_out=None) -> float:
    """Kernel vs plain version on the card (``plain_out``: the plain
    version's result on ``llr``, if already at hand); returns max |bits
    difference|."""
    bits_k, conv_k = dec(llr)
    bits_p, conv_p = plain_out if plain_out is not None else dec.plain(llr)
    torch.cuda.synchronize()
    assert bits_k.shape == bits_p.shape == llr.shape, label
    assert bool(torch.isfinite(bits_k).all()), label
    # float64: a float32 mean on the card scales by a rounded 1/N, so an
    # agreement of every bit can print as 0.99999994.
    agree = (bits_k == bits_p).double().mean().item()
    dconv = (conv_k - conv_p).abs().max().item()
    err = (bits_k - bits_p).abs().max().item()
    if dec.mode == "minsum":
        ok = bool(torch.equal(bits_k, bits_p)) and dconv == 0
    else:
        ok = agree >= 0.999 and dconv <= 1
    emit({"phase": "compare", "case": label, "bit_agreement": agree,
          "max_conv_diff": dconv, "max_abs_err": err, "ok": ok})
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {label}")
    return err


def wide_compare(max_err: dict) -> dict:
    """Phase 3's wide-row cases: rows of 31 and 58 members (Z=4), every
    schedule on its kernel's 64-bit state word, and of 121 (the limit) on
    its 128-bit word, each sum-product case also identical to fused through
    _launch_fused; the same rows at Z=8 on a fused_zlane decoder, every
    schedule on its large-Z kernel's 64-bit and 128-bit words, each case
    identical to fused_zlane through _launch_zlane; then rows wider than the
    retiring kernels take on the fused kernel (122 members, Z=4) and on
    fused_zlane (122, Z=8): min-sum flooding and layered sum-product.  These
    are the two kernels' own paths now, so their launches here (returned)
    are the kernels line's."""
    from ldpc_tpu_torch.ops import fused_minsum as fm

    flag_sets = ((True, False), (False, False), (True, True))
    for members, routes in ((31, fm.WIDE_ROUTES), (58, fm.WIDE_ROUTES), (121, fm.W128_ROUTES)):
        qcw = wide_row_code(members)
        for snr in (1.0, 4.0, 6.0):
            llr = llrs(qcw.num_vars, 37, snr, seed=members)
            for (tr, ee), (mode, sched) in itertools.product(flag_sets, WIDE_SCHEDULES):
                dec = fm.make_fused_minsum(qcw, 20, 0.75, track_convergence=tr, early_exit=ee,
                                           mode=mode, schedule=sched)
                assert dec.route in routes
                label = f"{dec.route} wide rows ({members} members) Z=4 B=37 {snr} dB " \
                        f"track={tr} early_exit={ee}"
                max_err[dec.route] = max(max_err[dec.route], compare(dec, llr, label))
                if mode == "sumproduct":
                    same_as_replaced(dec, llr, label)
    for members, routes in ((31, fm.ZLANE_WIDE_ROUTES), (58, fm.ZLANE_WIDE_ROUTES),
                            (121, fm.ZLANE_W128_ROUTES)):
        qcw = wide_row_code(members, Z=8)
        for snr in (1.0, 7.0):
            llr = llrs(qcw.num_vars, 37, snr, seed=members + 8)
            for (tr, ee), (mode, sched) in itertools.product(flag_sets, WIDE_SCHEDULES):
                dec = fm.make_fused_minsum_zlane(qcw, 20, 0.75, track_convergence=tr,
                                                 early_exit=ee, mode=mode, schedule=sched)
                assert dec.route in routes
                label = f"{dec.route} wide rows ({members} members) Z=8 B=37 {snr} dB " \
                        f"track={tr} early_exit={ee}"
                max_err[dec.route] = max(max_err[dec.route], compare(dec, llr, label))
                same_as_replaced(dec, llr, label)
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    for Z, build in ((4, fm.make_fused_minsum), (8, fm.make_fused_minsum_zlane)):
        qcw = wide_row_code(122, Z=Z)
        llr = llrs(qcw.num_vars, 37, 4.0, seed=5)
        for (tr, ee), mode in itertools.product(((True, False), (False, False), (True, True)),
                                                ("minsum", "sumproduct")):
            dec = build(qcw, 20, 0.75, track_convergence=tr, early_exit=ee, mode=mode,
                        schedule="flooding" if mode == "minsum" else "layered")
            assert dec.route == dec.kind and not dec.retire
            label = f"{dec.route} wide rows (122 members) Z={Z} B=37 {mode} " \
                    f"{dec.schedule} track={tr} early_exit={ee}"
            max_err[dec.route] = max(max_err[dec.route], compare(dec, llr, label))
    torch.cuda.synchronize()
    launches = dict(fm.LAUNCHES)
    if launches["fused"] < 6 or launches["fused_zlane"] < 6 or \
            sum(launches.values()) != launches["fused"] + launches["fused_zlane"]:
        raise AssertionError(f"wide rows did not run fused and fused_zlane alone: {launches}")
    return launches


def classical_phases(lib, smi: str) -> list[dict]:
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.models.classical import (
        BeliefPropagationDecoder, MinSumScaledDecoder, _resolve_backend, decode_min_sum)
    from ldpc_tpu_torch.ops import fused_minsum as fm, qc_msg
    from ldpc_tpu_torch.utils.metrics import decode_throughput

    # 3. compare each kernel with its plain version.  Min-sum runs on
    # fused_retire (flooding) and retire_layered (layered), sum-product on
    # retire_sumproduct (flooding) and retire_layered_sumproduct (layered).
    flags = [(m, s, tr, ee) for m in ("minsum", "sumproduct") for s in ("flooding", "layered")
             for tr, ee in ((True, False), (False, False), (True, True))]
    max_err = {name: 0.0 for name in fm.LAUNCHES}
    cases = [("fused", "toy_4x8", 4, 23, None, 0.5),
             ("fused", "nr_2_0_4", 4, 37, None, 1.0),
             ("fused", "nr_2_0_32", 24, 41, None, 1.5),
             ("fused", "nr_2_0_32", 32, 50, 3, 1.5),
             ("fused", "nr_2_0_32", 64, 29, None, 1.5),
             ("fused_zlane", "nr_2_0_32", 384, 20, 7, 1.5)]
    rlib = fm.retire_kernel_library()
    for kind_, code, Z, B, bt, snr in cases:
        qc = qc_layout(get_base_graph(code), Z)
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        if kind_ == "fused":  # the wrappers' shared-memory plans are the kernels'
            fpb = bt or fm.pick_fused_batch_tile(qc)
            assert lib.ldpc_fused_smem_bytes(*dims, fpb) == fm.fused_smem_bytes(qc, fpb)
            assert wide_smem_agree(qc, rlib)
            G = len(fm.row_groups(fm._structure(qc))) - 1
            for parts, frames, staged in fm.retire_sumproduct_plans(qc):
                assert rlib.ldpc_retire_sumproduct_smem_bytes(*dims, parts, frames, staged) == \
                    fm.retire_sumproduct_smem_bytes(qc, parts, frames, staged)
            for _, frames in fm.retire_layered_sumproduct_plans(qc):
                assert rlib.ldpc_retire_layered_sumproduct_smem_bytes(*dims, G, frames) == \
                    fm.retire_layered_sumproduct_smem_bytes(qc, frames)
        else:
            assert lib.ldpc_zlane_smem_bytes(*dims) == fm.zlane_smem_bytes(qc)
            assert zlane_smem_agree(qc)
        llr = llrs(qc.num_vars, B, snr, seed=Z)
        build = fm.make_fused_minsum if kind_ == "fused" else fm.make_fused_minsum_zlane
        for mode, sched, tr, ee in flags:
            dec = build(qc, 20, 0.75, batch_tile=bt, mode=mode, track_convergence=tr,
                        early_exit=ee, schedule=sched)
            label = f"{dec.route} {code} Z={Z} B={B} {mode} {sched} track={tr} early_exit={ee}"
            max_err[dec.route] = max(max_err[dec.route], compare(dec, llr, label))
            if dec.route in SUMPRODUCT_ROUTES:
                same_as_replaced(dec, llr, label)
    # The four Z=32 kernels and the four large-Z ones (Z=384; Z=256, a power
    # of two) on batches that hold frames
    # that never converge (-2 dB), converge at iteration 1 (6 dB) and a mix,
    # and on quantised LLRs with ties (m1 == m2) and exact zeros, -0.0 among
    # them (sign(0) = +1).
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    make_layered = functools.partial(fm.make_fused_minsum, schedule="layered")
    make_sumproduct = functools.partial(fm.make_fused_minsum, mode="sumproduct")
    make_sp_layered = functools.partial(fm.make_fused_minsum, mode="sumproduct",
                                        schedule="layered")
    zlane_builds = (fm.make_fused_minsum_zlane,
                    functools.partial(fm.make_fused_minsum_zlane, schedule="layered"),
                    functools.partial(fm.make_fused_minsum_zlane, mode="sumproduct"),
                    functools.partial(fm.make_fused_minsum_zlane, mode="sumproduct",
                                      schedule="layered"))
    hard = [(fm.make_fused_minsum, qc32, 1003), (make_layered, qc32, 1003),
            (make_sumproduct, qc32, 1003), (make_sp_layered, qc32, 1003)] + [
        (build, qc_layout(get_base_graph("nr_2_0_32"), Z), 301)
        for Z in (384, 256) for build in zlane_builds]
    for build, qc, B in hard:
        for snr, step in ((-2.0, None), (1.0, None), (6.0, None), (1.0, 1.0)):
            llr = llrs(qc.num_vars, B, snr, seed=7)
            if step:
                llr = torch.round(llr / step) * step
                llr[::5, ::7] = -0.0
            for tr, ee in ((True, False), (False, False), (True, True)):
                dec = build(qc, 20, 0.75, track_convergence=tr, early_exit=ee)
                assert dec.retire
                label = f"{dec.route} nr_2_0_32 Z={qc.Z} B={B} {snr} dB quantised={step} " \
                        f"{dec.schedule} track={tr} early_exit={ee}"
                max_err[dec.route] = max(max_err[dec.route], compare(dec, llr, label))
                if dec.route in SUMPRODUCT_ROUTES:
                    same_as_replaced(dec, llr, label)
    launches_wide = wide_compare(max_err)
    # Layered min-sum and both sum-product schedules on a row of 20 members:
    # the layered kernels' run-time loops for rows wider than their unrolled
    # bodies, and retire_sumproduct's phi parked in the c2v slots of rows
    # wider than the 12 it keeps in registers.
    qcw = wide_row_code(20)
    for snr in (1.0, 4.0, 6.0):
        llr = llrs(qcw.num_vars, 37, snr, seed=6)
        for (tr, ee), (mode, sched) in itertools.product(
                ((True, False), (False, False), (True, True)),
                (("minsum", "layered"), ("sumproduct", "flooding"), ("sumproduct", "layered"))):
            dec = fm.make_fused_minsum(qcw, 20, 0.75, track_convergence=tr, early_exit=ee,
                                       mode=mode, schedule=sched)
            assert dec.retire
            label = f"{dec.route} wide rows (20 members) Z=4 B=37 {snr} dB track={tr} " \
                    f"early_exit={ee}"
            max_err[dec.route] = max(max_err[dec.route], compare(dec, llr, label))
            if mode == "sumproduct":
                same_as_replaced(dec, llr, label)
    # The serving path against the tensor-op path (the JAX package's bar:
    # identical bits, conv_iter within 1 on at most 1% of frames).
    llr = llrs(qc32.num_vars, 256, 1.5, seed=1)
    bits_k, conv_k = fm.make_fused_minsum(qc32, 20, 0.75)(llr)
    ref = decode_min_sum(llr, qc_msg.make_plan(qc32), 20, 0.75)
    dconv = (conv_k - ref.conv_iter).abs()
    ok = bool((bits_k == ref.bits).all()) and int(dconv.max()) <= 1 and \
        float((dconv > 0).float().mean()) <= 0.01
    emit({"phase": "compare", "case": "fused_retire vs decode_min_sum nr_2_0_32 Z=32 B=256",
          "bits_identical": bool((bits_k == ref.bits).all()),
          "conv_diff_share": float((dconv > 0).float().mean()), "ok": ok})
    if not ok:
        raise AssertionError("fused_retire kernel disagrees with decode_min_sum")

    # 4. main path: nr_2_0_32 Z=32, batch 65536, 20 iterations, 3 dB
    ITERS, B = 20, 65536
    n = qc32.num_vars
    assert _resolve_backend("auto", qc32) == "fused"
    llr = llrs(n, B, 3.0, seed=0)
    server = MinSumScaledDecoder(qc32, ITERS, 0.75, early_stopping=False, backend="auto")
    stopping = MinSumScaledDecoder(qc32, ITERS, 0.75, early_stopping=True, backend="auto")
    fused = fm.make_fused_minsum(qc32, ITERS, 0.75)
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    bits_s, iters = server.decode(llr)
    bits_e, iters_e = stopping.decode(llr)
    bits, conv = fused(llr)
    torch.cuda.synchronize()
    launches_main = dict(fm.LAUNCHES)
    if launches_main["fused_retire"] < 3 or \
            sum(launches_main.values()) != launches_main["fused_retire"]:
        raise AssertionError(f"main path did not run fused_retire alone: {launches_main}")
    assert bits.shape == (B, n) and conv.shape == (B,) and conv.dtype == torch.int32
    assert bool(torch.equal(bits, bits_s)) and iters == ITERS
    assert bool(torch.equal(bits, bits_e)) and iters_e == int(conv.max())
    bit_errors = int(bits.sum().item())
    frame_errors = int((bits.sum(dim=1) > 0).sum().item())
    mean_conv = float(conv.float().mean().item())
    if bit_errors or not 2.9 <= mean_conv <= 3.1:
        raise AssertionError(f"main path decodes wrongly: {bit_errors} bit errors, "
                             f"mean conv_iter {mean_conv}")
    # The card's clocks settle under load; time once they have (about 1 s).
    settle = time.perf_counter() + 1.0
    while time.perf_counter() < settle:
        fused(llr)
        torch.cuda.synchronize()
    # The kernel and its other flags on the same batch, interleaved in rounds.
    flag_decs = {"tracked": fused,
                 "throughput_mode": fm.make_fused_minsum(qc32, ITERS, 0.75,
                                                         track_convergence=False),
                 "early_exit": fm.make_fused_minsum(qc32, ITERS, 0.75, early_exit=True)}
    rounds_ms = {name: [] for name in flag_decs}
    for _ in range(5):
        for name, dec in flag_decs.items():
            t, out = cuda_ms(lambda d=dec: d(llr), reps=4)
            rounds_ms[name].append(t)
            if name == "early_exit" and not (torch.equal(out[0], bits)
                                             and torch.equal(out[1], conv)):
                raise AssertionError("fused_retire with early exit differs")
    median = {name: sorted(r)[len(r) // 2] for name, r in rounds_ms.items()}
    ms = median["tracked"]
    ms_server, _ = cuda_ms(lambda: server.decode(llr), reps=5)
    plain_ms, plain_out = cuda_ms(lambda: fused.plain(llr), reps=1)
    err_main = compare(fused, llr, f"fused_retire main path B={B}", plain_out)
    del plain_out
    bms, bby = bound_ms(qc32, conv)
    occupancy = dict(zip(("parts", "frames_per_block", "blocks_per_sm"),
                         fm.retire_plan(qc32, True)))
    occupancy["frames_per_sm"] = occupancy["frames_per_block"] * occupancy["blocks_per_sm"]
    occupancy["warps_per_sm"] = occupancy["frames_per_sm"] * occupancy["parts"]
    occupancy["smem_bytes_per_frame"] = fm.retire_smem_bytes(qc32, 1, 2) - \
        fm.retire_smem_bytes(qc32, 1, 1)
    emit({"phase": "trace_main", "batch": B, **trace_split(lambda: fused(llr), "main")})
    emit({"phase": "main", "code": "nr_2_0_32", "Z": 32, "batch": B, "iterations": ITERS,
          "snr_db": 3.0, "backend": "fused_retire", "launches": launches_main,
          "bits_per_s": decode_throughput(B, n, ms / 1e3, name="minsum"),
          "ms_per_batch": ms, "bound_ms": bms, "bound_by": bby,
          "server_ms_per_batch": ms_server, "plain_ms": plain_ms,
          "variants_ms": {name: median[name] for name in ("throughput_mode", "early_exit")},
          "rounds_ms": rounds_ms, "occupancy": occupancy,
          "bit_errors": bit_errors,
          "frame_errors": frame_errors, "mean_conv_iter": mean_conv, "nvidia_smi": smi})

    # 4b. the layered min-sum serving path on retire_layered (same code,
    # batch and SNR as the main path)
    layered = MinSumScaledDecoder(qc32, ITERS, 0.75, early_stopping=False, backend="auto",
                                  schedule="layered")
    lay_dec = fm.make_fused_minsum(qc32, ITERS, 0.75, schedule="layered")
    lay_thr = fm.make_fused_minsum(qc32, ITERS, 0.75, schedule="layered",
                                   track_convergence=False)
    assert layered._fused.route == lay_dec.route == lay_thr.route == "retire_layered"
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    bits_l, _ = layered.decode(llr)
    bits_ld, conv_l = lay_dec(llr)
    torch.cuda.synchronize()
    launches_lay = dict(fm.LAUNCHES)
    if launches_lay["retire_layered"] < 2 or \
            sum(launches_lay.values()) != launches_lay["retire_layered"]:
        raise AssertionError(f"layered path did not run retire_layered alone: {launches_lay}")
    assert bits_ld.shape == (B, n) and bool(torch.equal(bits_l, bits_ld))
    bit_errors_l = int(bits_ld.sum().item())
    mean_conv_l = float(conv_l.float().mean().item())
    if bit_errors_l or not 1.0 <= mean_conv_l <= 3.0:
        raise AssertionError(f"layered path decodes wrongly: {bit_errors_l} bit errors, "
                             f"mean conv_iter {mean_conv_l}")
    plain_ms_lay, plain_out = cuda_ms(lambda: lay_dec.plain(llr), reps=1)
    err_lay = compare(lay_dec, llr, f"retire_layered layered path B={B}", plain_out)
    del plain_out
    err_lay = max(err_lay, compare(lay_thr, llr, f"retire_layered layered path B={B} "
                                                 "throughput mode"))
    settle = time.perf_counter() + 1.0
    while time.perf_counter() < settle:
        lay_dec(llr)
        torch.cuda.synchronize()
    # The kernel, its throughput mode and the kernel it replaced on the same
    # batch, interleaved in rounds.
    lay_runs = {"tracked": (lambda: lay_dec(llr), 10),
                "throughput_mode": (lambda: lay_thr(llr), 3),
                "replaced_fused": (lambda: lay_dec._launch_fused(llr), 1)}
    lay_rounds = {name: [] for name in lay_runs}
    for _ in range(5):
        for name, (fn, reps) in lay_runs.items():
            t, out = cuda_ms(fn, reps=reps)
            lay_rounds[name].append(t)
            if name == "replaced_fused" and not (torch.equal(out[0], bits_ld)
                                                 and torch.equal(out[1], conv_l)):
                raise AssertionError("the replaced fused kernel's layered output differs")
    lay_median = {name: sorted(r)[len(r) // 2] for name, r in lay_rounds.items()}
    ms_lay = lay_median["tracked"]
    # What a frame's warps buy: the rows of a row group on 1, 2 or 3 warps.
    lay_parts = {p: cuda_ms(lambda p=p: lay_dec._launch_retire(llr, parts=p), reps=5)[0]
                 for p in sorted({p for p, _ in fm.retire_layered_plans(qc32)})}
    bms_lay, bby_lay = bound_ms(qc32, conv_l, layered=True)
    lay_occupancy = dict(zip(("parts", "frames_per_block", "blocks_per_sm"),
                             fm.retire_layered_plan(qc32, True)))
    lay_occupancy["warps_per_sm"] = (lay_occupancy["parts"] * lay_occupancy["frames_per_block"]
                                     * lay_occupancy["blocks_per_sm"])
    lay_occupancy["smem_bytes_per_frame"] = fm.retire_layered_smem_bytes(qc32, 2) - \
        fm.retire_layered_smem_bytes(qc32, 1)
    lay_occupancy["smem_bytes_per_block"] = fm.retire_layered_smem_bytes(
        qc32, lay_occupancy["frames_per_block"])
    lay_occupancy["ptxas"] = ptxas_of("fused_retire", "retire_layered_kernel")
    emit(trace_in_child("layered"))
    emit({"phase": "layered", "code": "nr_2_0_32", "Z": 32, "batch": B, "iterations": ITERS,
          "snr_db": 3.0, "backend": "retire_layered", "launches": launches_lay,
          "bits_per_s": decode_throughput(B, n, ms_lay / 1e3, name="layered"),
          "ms_per_batch": ms_lay, "bound_ms": bms_lay, "bound_by": bby_lay,
          "plain_ms": plain_ms_lay,
          "variants_ms": {name: lay_median[name] for name in ("throughput_mode",
                                                              "replaced_fused")},
          "speedup_over_replaced": lay_median["replaced_fused"] / ms_lay,
          "rounds_ms": lay_rounds, "layered_parts_ms": lay_parts, "occupancy": lay_occupancy,
          "bit_errors": bit_errors_l, "mean_conv_iter": mean_conv_l, "nvidia_smi": smi})

    # 4c. sum-product flooding on retire_sumproduct (same code, batch and SNR)
    bp_server = BeliefPropagationDecoder(qc32, ITERS, early_stopping=False, backend="auto")
    bp_dec = fm.make_fused_bp(qc32, ITERS)
    bp_thr = fm.make_fused_minsum(qc32, ITERS, 1.0, mode="sumproduct", track_convergence=False)
    assert bp_server._fused.route == bp_dec.route == bp_thr.route == "retire_sumproduct"
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    bits_b, _ = bp_server.decode(llr)
    bits_bd, conv_b = bp_dec(llr)
    torch.cuda.synchronize()
    launches_sp = dict(fm.LAUNCHES)
    if launches_sp["retire_sumproduct"] < 2 or \
            sum(launches_sp.values()) != launches_sp["retire_sumproduct"]:
        raise AssertionError(f"sum-product path did not run retire_sumproduct alone: {launches_sp}")
    assert bits_bd.shape == (B, n) and bool(torch.equal(bits_b, bits_bd))
    bit_errors_b = int(bits_bd.sum().item())
    mean_conv_b = float(conv_b.float().mean().item())
    if bit_errors_b or not 1.0 <= mean_conv_b <= 5.0:
        raise AssertionError(f"sum-product path decodes wrongly: {bit_errors_b} bit errors, "
                             f"mean conv_iter {mean_conv_b}")
    plain_ms_sp, plain_out = cuda_ms(lambda: bp_dec.plain(llr), reps=1)
    err_sp = compare(bp_dec, llr, f"retire_sumproduct sum-product path B={B}", plain_out)
    del plain_out
    err_sp = max(err_sp, compare(bp_thr, llr, f"retire_sumproduct sum-product path B={B} "
                                              "throughput mode"))
    settle = time.perf_counter() + 1.0
    while time.perf_counter() < settle:
        bp_dec(llr)
        torch.cuda.synchronize()
    # The kernel, its throughput mode and the kernel it replaced on the same
    # batch, interleaved in rounds; the replaced kernel's output identical.
    sp_runs = {"tracked": (lambda: bp_dec(llr), 5),
               "throughput_mode": (lambda: bp_thr(llr), 2),
               "replaced_fused": (lambda: bp_dec._launch_fused(llr), 1)}
    sp_rounds = {name: [] for name in sp_runs}
    for _ in range(5):
        for name, (fn, reps) in sp_runs.items():
            t, out = cuda_ms(fn, reps=reps)
            sp_rounds[name].append(t)
            if name == "replaced_fused" and not (torch.equal(out[0], bits_bd)
                                                 and torch.equal(out[1], conv_b)):
                raise AssertionError("the replaced fused kernel's sum-product output differs")
    sp_median = {name: sorted(r)[len(r) // 2] for name, r in sp_rounds.items()}
    ms_sp = sp_median["tracked"]
    bms_sp, bby_sp = bp_bound_ms(qc32, conv_b)
    sp_occupancy = dict(zip(("parts", "frames_per_block", "staged_llrs", "blocks_per_sm"),
                            fm.retire_sumproduct_plan(qc32, True)))
    sp_occupancy["warps_per_sm"] = (sp_occupancy["parts"] * sp_occupancy["frames_per_block"]
                                    * sp_occupancy["blocks_per_sm"])
    staged = sp_occupancy["staged_llrs"]
    sp_occupancy["smem_bytes_per_frame"] = fm.retire_sumproduct_smem_bytes(
        qc32, 1, 2, staged) - fm.retire_sumproduct_smem_bytes(qc32, 1, 1, staged)
    sp_occupancy["smem_bytes_per_block"] = fm.retire_sumproduct_smem_bytes(
        qc32, sp_occupancy["parts"], sp_occupancy["frames_per_block"], staged)
    sp_occupancy["ptxas"] = ptxas_of("fused_retire", "retire_sumproduct_kernel")
    emit(trace_in_child("sumproduct"))
    emit({"phase": "sumproduct", "code": "nr_2_0_32", "Z": 32, "batch": B, "iterations": ITERS,
          "snr_db": 3.0, "backend": "retire_sumproduct", "launches": launches_sp,
          "bits_per_s": decode_throughput(B, n, ms_sp / 1e3, name="sumproduct"),
          "ms_per_batch": ms_sp, "bound_ms": bms_sp, "bound_by": bby_sp,
          "plain_ms": plain_ms_sp,
          "variants_ms": {name: sp_median[name] for name in ("throughput_mode", "replaced_fused")},
          "speedup_over_replaced": sp_median["replaced_fused"] / ms_sp,
          "rounds_ms": sp_rounds, "occupancy": sp_occupancy, "bit_errors": bit_errors_b,
          "mean_conv_iter": mean_conv_b, "nvidia_smi": smi})

    # 4d. layered sum-product on retire_layered_sumproduct (same batch)
    sp_lay = fm.make_fused_minsum(qc32, ITERS, 1.0, mode="sumproduct", schedule="layered")
    sp_lay_thr = fm.make_fused_minsum(qc32, ITERS, 1.0, mode="sumproduct", schedule="layered",
                                      track_convergence=False)
    assert sp_lay.route == sp_lay_thr.route == "retire_layered_sumproduct"
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    bits_sl, conv_sl = sp_lay(llr)
    torch.cuda.synchronize()
    launches_sl = dict(fm.LAUNCHES)
    if launches_sl["retire_layered_sumproduct"] < 1 or \
            sum(launches_sl.values()) != launches_sl["retire_layered_sumproduct"]:
        raise AssertionError(f"layered sum-product did not run retire_layered_sumproduct "
                             f"alone: {launches_sl}")
    bit_errors_sl = int(bits_sl.sum().item())
    mean_conv_sl = float(conv_sl.float().mean().item())
    if bits_sl.shape != (B, n) or bit_errors_sl or not 1.0 <= mean_conv_sl <= 3.0:
        raise AssertionError(f"layered sum-product decodes wrongly: {bit_errors_sl} bit errors, "
                             f"mean conv_iter {mean_conv_sl}")
    plain_ms_sl, plain_out = cuda_ms(lambda: sp_lay.plain(llr), reps=1)
    err_sl = compare(sp_lay, llr, f"retire_layered_sumproduct layered sum-product B={B}",
                     plain_out)
    del plain_out
    err_sl = max(err_sl, compare(sp_lay_thr, llr, f"retire_layered_sumproduct layered "
                                                  f"sum-product B={B} throughput mode"))
    settle = time.perf_counter() + 1.0
    while time.perf_counter() < settle:
        sp_lay(llr)
        torch.cuda.synchronize()
    # The kernel, its throughput mode and the kernel it replaced on the same
    # batch, interleaved in rounds; the replaced kernel's output identical.
    sl_runs = {"tracked": (lambda: sp_lay(llr), 5),
               "throughput_mode": (lambda: sp_lay_thr(llr), 2),
               "replaced_fused": (lambda: sp_lay._launch_fused(llr), 1)}
    sl_rounds = {name: [] for name in sl_runs}
    for _ in range(5):
        for name, (fn, reps) in sl_runs.items():
            t, out = cuda_ms(fn, reps=reps)
            sl_rounds[name].append(t)
            if name != "throughput_mode" and not (torch.equal(out[0], bits_sl)
                                                  and torch.equal(out[1], conv_sl)):
                raise AssertionError(f"{name} differs from retire_layered_sumproduct")
    sl_median = {name: sorted(r)[len(r) // 2] for name, r in sl_rounds.items()}
    ms_sl = sl_median["tracked"]
    # What a frame's warps buy: the rows of a row group on 1, 2 or 3 warps.
    sl_parts = {p: cuda_ms(lambda p=p: sp_lay._launch_retire(llr, parts=p), reps=5)[0]
                for p in sorted({p for p, _ in fm.retire_layered_sumproduct_plans(qc32)})}
    # c2v in L2 slices instead of shared memory (retire_zlane_layered_sumproduct
    # at Z=32), its plan at each parts count (frames an SM as the occupancy
    # query allows); outputs identical.
    sliced = fm.make_fused_minsum_zlane(qc32, ITERS, 1.0, mode="sumproduct",
                                        schedule="layered")
    sl_slices = {}
    for p in sorted({p for p, _ in fm.retire_zlane_layered_sumproduct_plans(qc32)}):
        out = sliced._launch_retire(llr, parts=p)
        if not (torch.equal(out[0], bits_sl) and torch.equal(out[1], conv_sl)):
            raise AssertionError("retire_zlane_layered_sumproduct differs at Z=32")
        _, frames, per_sm = fm.retire_zlane_layered_sumproduct_plan(qc32, True, p)
        sl_slices[f"parts={p} frames_per_sm={frames * per_sm}"] = cuda_ms(
            lambda p=p: sliced._launch_retire(llr, parts=p), reps=5)[0]
    del out
    bms_sl, bby_sl = bp_bound_ms(qc32, conv_sl, layered=True)
    sl_plan = fm.retire_layered_sumproduct_plan(qc32, True)
    sl_occupancy = dict(zip(("parts", "frames_per_block", "blocks_per_sm"), sl_plan))
    sl_occupancy["warps_per_sm"] = sl_plan[0] * sl_plan[1] * sl_plan[2]
    sl_occupancy["smem_bytes_per_frame"] = fm.retire_layered_sumproduct_smem_bytes(qc32, 2) - \
        fm.retire_layered_sumproduct_smem_bytes(qc32, 1)
    sl_occupancy["smem_bytes_per_block"] = fm.retire_layered_sumproduct_smem_bytes(
        qc32, sl_plan[1])
    sl_occupancy["ptxas"] = ptxas_of("fused_retire", "retire_layered_sumproduct_kernel")
    emit({"phase": "sumproduct_layered", "code": "nr_2_0_32", "Z": 32, "batch": B,
          "iterations": ITERS, "snr_db": 3.0, "backend": "retire_layered_sumproduct",
          "launches": launches_sl,
          "bits_per_s": decode_throughput(B, n, ms_sl / 1e3, name="sumproduct_layered"),
          "ms_per_batch": ms_sl, "bound_ms": bms_sl, "bound_by": bby_sl,
          "plain_ms": plain_ms_sl,
          "variants_ms": {name: sl_median[name] for name in sl_runs if name != "tracked"},
          "speedup_over_replaced": sl_median["replaced_fused"] / ms_sl,
          "rounds_ms": sl_rounds, "parts_ms": sl_parts, "c2v_in_l2_slices_ms": sl_slices,
          "occupancy": sl_occupancy,
          "bit_errors": bit_errors_sl, "mean_conv_iter": mean_conv_sl, "nvidia_smi": smi})

    # 5. Z=384 path (bench.py section_z384): auto resolves to fused_zlane,
    # whose min-sum flooding runs on retire_zlane
    B384 = Z384["B"]
    qc384 = qc_layout(get_base_graph("nr_2_0_32"), 384)
    assert _resolve_backend("auto", qc384) == "fused_zlane"
    n384 = qc384.num_vars
    llr384 = llrs(n384, B384, Z384["SNR"], seed=Z384["llr_seed"])
    server384 = MinSumScaledDecoder(qc384, ITERS, 0.75, early_stopping=False, backend="auto")
    zfused = fm.make_fused_minsum_zlane(qc384, ITERS, 0.75)
    zthr = fm.make_fused_minsum_zlane(qc384, ITERS, 0.75, track_convergence=False)
    assert zfused.route == zthr.route == "retire_zlane"
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    bits_s, _ = server384.decode(llr384)
    bits, conv = zfused(llr384)
    torch.cuda.synchronize()
    launches_z = dict(fm.LAUNCHES)
    if launches_z["retire_zlane"] < 2 or sum(launches_z.values()) != launches_z["retire_zlane"]:
        raise AssertionError(f"Z=384 path did not run the retire_zlane kernel alone: {launches_z}")
    assert bits.shape == (B384, n384) and bool(torch.equal(bits, bits_s))
    bit_errors384 = int(bits.sum().item())
    frame_errors384 = int((bits.sum(dim=1) > 0).sum().item())
    mean_conv384 = float(conv.float().mean().item())
    if bit_errors384 or not 2.0 <= mean_conv384 <= 6.0:
        raise AssertionError(f"Z=384 path decodes wrongly: {bit_errors384} bit errors, "
                             f"mean conv_iter {mean_conv384}")
    plain_ms384, plain_out = cuda_ms(lambda: zfused.plain(llr384), reps=1)
    err_z = compare(zfused, llr384, f"retire_zlane z384 B={B384}", plain_out)
    del plain_out
    err_z = max(err_z, compare(zthr, llr384, f"retire_zlane z384 B={B384} throughput mode"))
    settle = time.perf_counter() + 1.0
    while time.perf_counter() < settle:
        zfused(llr384)
        torch.cuda.synchronize()
    # The kernel, its throughput mode and the kernel it replaced on the same
    # batch, interleaved in rounds.
    z_runs = {"tracked": (lambda: zfused(llr384), 10),
              "throughput_mode": (lambda: zthr(llr384), 5),
              "replaced_fused_zlane": (lambda: zfused._launch_zlane(llr384), 3)}
    z_rounds = {name: [] for name in z_runs}
    for _ in range(5):
        for name, (fn, reps) in z_runs.items():
            t, out = cuda_ms(fn, reps=reps)
            z_rounds[name].append(t)
            if name == "replaced_fused_zlane" and not (torch.equal(out[0], bits)
                                                       and torch.equal(out[1], conv)):
                raise AssertionError("the replaced fused_zlane kernel's output differs")
    z_median = {name: sorted(r)[len(r) // 2] for name, r in z_rounds.items()}
    ms384 = z_median["tracked"]
    bms384, bby384 = bound_ms(qc384, conv)
    z_occupancy = dict(zip(("parts", "blocks_per_sm"), fm.retire_zlane_plan(qc384, True)))
    z_occupancy["warps_per_block"] = fm.retire_threads(qc384, z_occupancy["parts"], 1) // 32
    z_occupancy["smem_bytes"] = fm.retire_zlane_smem_bytes(qc384, z_occupancy["parts"])
    z_occupancy["scratch_bytes_per_block"] = fm.retire_zlane_scratch_bytes(qc384)
    z_probe = split_probe(zfused, llr384, ITERS)
    emit(trace_in_child("z384"))
    emit({"phase": "z384", "code": "nr_2_0_32", "Z": 384, "batch": B384, "iterations": ITERS,
          "snr_db": Z384["SNR"], "backend": "retire_zlane", "launches": launches_z,
          "bits_per_s": decode_throughput(B384, n384, ms384 / 1e3, name="z384"),
          "ms_per_batch": ms384, "plain_ms": plain_ms384, "bound_ms": bms384,
          "bound_by": bby384,
          "variants_ms": {name: z_median[name]
                          for name in ("throughput_mode", "replaced_fused_zlane")},
          "speedup_over_replaced": z_median["replaced_fused_zlane"] / ms384,
          "rounds_ms": z_rounds, "occupancy": z_occupancy, "split_probe": z_probe,
          "bit_errors": bit_errors384,
          "frame_errors": frame_errors384, "mean_conv_iter": mean_conv384, "nvidia_smi": smi})

    # 5b. layered min-sum at Z=384 on retire_zlane_layered (same batch)
    zlay_server = MinSumScaledDecoder(qc384, ITERS, 0.75, early_stopping=False, backend="auto",
                                      schedule="layered")
    zlay = fm.make_fused_minsum_zlane(qc384, ITERS, 0.75, schedule="layered")
    zlay_thr = fm.make_fused_minsum_zlane(qc384, ITERS, 0.75, schedule="layered",
                                          track_convergence=False)
    assert zlay_server._fused.route == zlay.route == zlay_thr.route == "retire_zlane_layered"
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    bits_zl, _ = zlay_server.decode(llr384)
    bits_zld, conv_zl = zlay(llr384)
    torch.cuda.synchronize()
    launches_zl = dict(fm.LAUNCHES)
    if launches_zl["retire_zlane_layered"] < 2 or \
            sum(launches_zl.values()) != launches_zl["retire_zlane_layered"]:
        raise AssertionError(f"Z=384 layered path did not run retire_zlane_layered alone: "
                             f"{launches_zl}")
    assert bits_zld.shape == (B384, n384) and bool(torch.equal(bits_zl, bits_zld))
    bit_errors_zl = int(bits_zld.sum().item())
    mean_conv_zl = float(conv_zl.float().mean().item())
    if bit_errors_zl or not 1.0 <= mean_conv_zl <= 4.0:
        raise AssertionError(f"Z=384 layered path decodes wrongly: {bit_errors_zl} bit errors, "
                             f"mean conv_iter {mean_conv_zl}")
    plain_ms_zl, plain_out = cuda_ms(lambda: zlay.plain(llr384), reps=1)
    err_zl = compare(zlay, llr384, f"retire_zlane_layered z384 B={B384}", plain_out)
    del plain_out
    err_zl = max(err_zl, compare(zlay_thr, llr384, f"retire_zlane_layered z384 B={B384} "
                                                   "throughput mode"))
    settle = time.perf_counter() + 1.0
    while time.perf_counter() < settle:
        zlay(llr384)
        torch.cuda.synchronize()
    # The kernel, its throughput mode and the kernel it replaced on the same
    # batch, interleaved in rounds; the replaced kernel's output identical.
    zl_runs = {"tracked": (lambda: zlay(llr384), 10),
               "throughput_mode": (lambda: zlay_thr(llr384), 5),
               "replaced_fused_zlane": (lambda: zlay._launch_zlane(llr384), 3)}
    zl_rounds = {name: [] for name in zl_runs}
    for _ in range(5):
        for name, (fn, reps) in zl_runs.items():
            t, out = cuda_ms(fn, reps=reps)
            zl_rounds[name].append(t)
            if name != "throughput_mode" and not (torch.equal(out[0], bits_zld)
                                                  and torch.equal(out[1], conv_zl)):
                raise AssertionError(f"{name} differs from retire_zlane_layered at Z=384")
    zl_median = {name: sorted(r)[len(r) // 2] for name, r in zl_rounds.items()}
    ms_zl = zl_median["tracked"]
    # Each split of a frame's row groups.
    zl_parts = {p: cuda_ms(lambda p=p: zlay._launch_retire(llr384, parts=p), reps=5)[0]
                for p in sorted({p for p, _ in fm.retire_zlane_layered_plans(qc384)})}
    bms_zl, bby_zl = bound_ms(qc384, conv_zl, layered=True)
    zl_plan = fm.retire_zlane_layered_plan(qc384, True)
    zl_occupancy = dict(zip(("parts", "frames_per_block", "blocks_per_sm"), zl_plan))
    zl_occupancy["warps_per_sm"] = (zl_plan[0] * zl_plan[1] * zl_plan[2]
                                    * fm.retire_threads(qc384, 1, 1) // 32)
    zl_occupancy["smem_bytes_per_block"] = fm.retire_zlane_layered_smem_bytes(qc384, zl_plan[1])
    zl_occupancy["scratch_bytes_per_frame"] = fm.retire_zlane_layered_scratch_bytes(qc384)
    zl_occupancy["ptxas"] = ptxas_of("fused_retire", "retire_zlane_layered_kernel")
    emit({"phase": "z384_layered", "code": "nr_2_0_32", "Z": 384, "batch": B384,
          "iterations": ITERS, "snr_db": Z384["SNR"], "backend": "retire_zlane_layered",
          "launches": launches_zl,
          "bits_per_s": decode_throughput(B384, n384, ms_zl / 1e3, name="z384_layered"),
          "ms_per_batch": ms_zl, "bound_ms": bms_zl, "bound_by": bby_zl,
          "plain_ms": plain_ms_zl,
          "variants_ms": {name: zl_median[name] for name in zl_runs if name != "tracked"},
          "speedup_over_replaced": zl_median["replaced_fused_zlane"] / ms_zl,
          "rounds_ms": zl_rounds, "parts_ms": zl_parts, "occupancy": zl_occupancy,
          "bit_errors": bit_errors_zl, "mean_conv_iter": mean_conv_zl, "nvidia_smi": smi})

    # 5c. sum-product flooding at Z=384 on retire_zlane_sumproduct (same batch)
    bp384 = BeliefPropagationDecoder(qc384, ITERS, early_stopping=False, backend="auto")
    zsp = fm.make_fused_minsum_zlane(qc384, ITERS, 1.0, mode="sumproduct")
    zsp_thr = fm.make_fused_minsum_zlane(qc384, ITERS, 1.0, mode="sumproduct",
                                         track_convergence=False)
    assert bp384._fused.route == zsp.route == zsp_thr.route == "retire_zlane_sumproduct"
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    bits_zs, _ = bp384.decode(llr384)
    bits_zsd, conv_zs = zsp(llr384)
    torch.cuda.synchronize()
    launches_zs = dict(fm.LAUNCHES)
    if launches_zs["retire_zlane_sumproduct"] < 2 or \
            sum(launches_zs.values()) != launches_zs["retire_zlane_sumproduct"]:
        raise AssertionError(f"Z=384 sum-product path did not run retire_zlane_sumproduct "
                             f"alone: {launches_zs}")
    assert bits_zsd.shape == (B384, n384) and bool(torch.equal(bits_zs, bits_zsd))
    bit_errors_zs = int(bits_zsd.sum().item())
    mean_conv_zs = float(conv_zs.float().mean().item())
    if bit_errors_zs or not 1.0 <= mean_conv_zs <= 6.0:
        raise AssertionError(f"Z=384 sum-product path decodes wrongly: {bit_errors_zs} bit "
                             f"errors, mean conv_iter {mean_conv_zs}")
    plain_ms_zs, plain_out = cuda_ms(lambda: zsp.plain(llr384), reps=1)
    err_zs = compare(zsp, llr384, f"retire_zlane_sumproduct z384 B={B384}", plain_out)
    del plain_out
    err_zs = max(err_zs, compare(zsp_thr, llr384, f"retire_zlane_sumproduct z384 B={B384} "
                                                  "throughput mode"))
    same_as_replaced(zsp_thr, llr384, f"retire_zlane_sumproduct z384 B={B384} throughput mode")
    settle = time.perf_counter() + 1.0
    while time.perf_counter() < settle:
        zsp(llr384)
        torch.cuda.synchronize()
    # The kernel, its throughput mode and the kernel it replaced on the same
    # batch, interleaved in rounds; the replaced kernel's output identical.
    zs_runs = {"tracked": (lambda: zsp(llr384), 5),
               "throughput_mode": (lambda: zsp_thr(llr384), 2),
               "replaced_fused_zlane": (lambda: zsp._launch_zlane(llr384), 1)}
    zs_rounds = {name: [] for name in zs_runs}
    for _ in range(5):
        for name, (fn, reps) in zs_runs.items():
            t, out = cuda_ms(fn, reps=reps)
            zs_rounds[name].append(t)
            if name != "throughput_mode" and not (torch.equal(out[0], bits_zsd)
                                                  and torch.equal(out[1], conv_zs)):
                raise AssertionError(f"{name} differs from retire_zlane_sumproduct at Z=384")
    zs_median = {name: sorted(r)[len(r) // 2] for name, r in zs_rounds.items()}
    ms_zs = zs_median["tracked"]
    zs_parts = {p: cuda_ms(lambda p=p: zsp._launch_retire(llr384, parts=p), reps=5)[0]
                for p in fm.retire_zlane_sumproduct_plans(qc384)}
    bms_zs, bby_zs = bp_bound_ms(qc384, conv_zs)
    zs_occupancy = dict(zip(("parts", "blocks_per_sm"), fm.retire_zlane_sumproduct_plan(qc384,
                                                                                      True)))
    # What the occupancy query allows before the plan's cap.
    zs_occupancy["blocks_per_sm_by_occupancy"] = {
        p: fm.retire_kernel_library().ldpc_retire_zlane_sumproduct_occupancy(
            384, qc384.num_base_rows, qc384.num_base_cols, qc384.num_base_edges, p, 1, 32)
        for p in fm.retire_zlane_sumproduct_plans(qc384)}
    zs_occupancy["smem_bytes"] = fm.retire_zlane_sumproduct_smem_bytes(qc384,
                                                                       zs_occupancy["parts"])
    zs_occupancy["scratch_bytes_per_block"] = fm.retire_zlane_sumproduct_scratch_bytes(qc384)
    zs_occupancy["ptxas"] = ptxas_of("fused_retire", "retire_zlane_sumproduct_kernel")
    emit({"phase": "z384_sumproduct", "code": "nr_2_0_32", "Z": 384, "batch": B384,
          "iterations": ITERS, "snr_db": Z384["SNR"], "backend": "retire_zlane_sumproduct",
          "launches": launches_zs,
          "bits_per_s": decode_throughput(B384, n384, ms_zs / 1e3, name="z384_sumproduct"),
          "ms_per_batch": ms_zs, "bound_ms": bms_zs, "bound_by": bby_zs,
          "plain_ms": plain_ms_zs,
          "variants_ms": {name: zs_median[name] for name in zs_runs if name != "tracked"},
          "speedup_over_replaced": zs_median["replaced_fused_zlane"] / ms_zs,
          "rounds_ms": zs_rounds, "parts_ms": zs_parts, "occupancy": zs_occupancy,
          "bit_errors": bit_errors_zs, "mean_conv_iter": mean_conv_zs, "nvidia_smi": smi})

    # 5d. layered sum-product at Z=384 on retire_zlane_layered_sumproduct
    # (same batch)
    zsl = fm.make_fused_minsum_zlane(qc384, ITERS, 1.0, mode="sumproduct", schedule="layered")
    zsl_thr = fm.make_fused_minsum_zlane(qc384, ITERS, 1.0, mode="sumproduct",
                                         schedule="layered", track_convergence=False)
    assert zsl.route == zsl_thr.route == "retire_zlane_layered_sumproduct"
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    bits_zsl, conv_zsl = zsl(llr384)
    torch.cuda.synchronize()
    launches_zsl = dict(fm.LAUNCHES)
    if launches_zsl["retire_zlane_layered_sumproduct"] < 1 or \
            sum(launches_zsl.values()) != launches_zsl["retire_zlane_layered_sumproduct"]:
        raise AssertionError(f"Z=384 layered sum-product did not run "
                             f"retire_zlane_layered_sumproduct alone: {launches_zsl}")
    bit_errors_zsl = int(bits_zsl.sum().item())
    mean_conv_zsl = float(conv_zsl.float().mean().item())
    if bits_zsl.shape != (B384, n384) or bit_errors_zsl or not 1.0 <= mean_conv_zsl <= 4.0:
        raise AssertionError(f"Z=384 layered sum-product decodes wrongly: {bit_errors_zsl} "
                             f"bit errors, mean conv_iter {mean_conv_zsl}")
    plain_ms_zsl, plain_out = cuda_ms(lambda: zsl.plain(llr384), reps=1)
    err_zsl = compare(zsl, llr384, f"retire_zlane_layered_sumproduct z384 B={B384}", plain_out)
    del plain_out
    err_zsl = max(err_zsl, compare(zsl_thr, llr384, f"retire_zlane_layered_sumproduct z384 "
                                                    f"B={B384} throughput mode"))
    # One frame group of two parts an SM, against the plan's two groups of
    # one part.
    one_group_plan = fm.retire_zlane_layered_sumproduct_plan(qc384, True, 2)
    settle = time.perf_counter() + 1.0
    while time.perf_counter() < settle:
        zsl(llr384)
        torch.cuda.synchronize()
    # The kernel, its throughput mode, the replaced kernel and one frame
    # group an SM on the same batch, interleaved in rounds; outputs identical.
    zsl_runs = {"tracked": (lambda: zsl(llr384), 10),
                "throughput_mode": (lambda: zsl_thr(llr384), 3),
                "replaced_fused_zlane": (lambda: zsl._launch_zlane(llr384), 1),
                "one_frame_group_parts_2": (lambda: zsl._launch_retire(llr384, parts=2), 10)}
    zsl_rounds = {name: [] for name in zsl_runs}
    for _ in range(5):
        for name, (fn, reps) in zsl_runs.items():
            t, out = cuda_ms(fn, reps=reps)
            zsl_rounds[name].append(t)
            if name != "throughput_mode" and not (torch.equal(out[0], bits_zsl)
                                                  and torch.equal(out[1], conv_zsl)):
                raise AssertionError(f"{name} differs from retire_zlane_layered_sumproduct")
    zsl_median = {name: sorted(r)[len(r) // 2] for name, r in zsl_rounds.items()}
    ms_zsl = zsl_median["tracked"]
    zsl_parts = {p: cuda_ms(lambda p=p: zsl._launch_retire(llr384, parts=p), reps=5)[0]
                 for p in sorted({p for p, _ in fm.retire_zlane_layered_sumproduct_plans(qc384)})}
    bms_zsl, bby_zsl = bp_bound_ms(qc384, conv_zsl, layered=True)
    zsl_plan = fm.retire_zlane_layered_sumproduct_plan(qc384, True)
    zsl_occupancy = {**dict(zip(("parts", "frames_per_block", "blocks_per_sm"), zsl_plan)),
                     "plan_at_parts_2": one_group_plan}
    zsl_occupancy["warps_per_sm"] = (zsl_plan[0] * zsl_plan[1] * zsl_plan[2]
                                     * fm.retire_threads(qc384, 1, 1) // 32)
    zsl_occupancy["smem_bytes_per_block"] = fm.retire_zlane_layered_sumproduct_smem_bytes(
        qc384, zsl_plan[1])
    zsl_occupancy["scratch_bytes_per_frame"] = \
        fm.retire_zlane_layered_sumproduct_scratch_bytes(qc384)
    zsl_occupancy["ptxas"] = ptxas_of("fused_retire", "retire_zlane_layered_sumproduct_kernel")
    emit({"phase": "z384_sumproduct_layered", "code": "nr_2_0_32", "Z": 384, "batch": B384,
          "iterations": ITERS, "snr_db": Z384["SNR"],
          "backend": "retire_zlane_layered_sumproduct", "launches": launches_zsl,
          "bits_per_s": decode_throughput(B384, n384, ms_zsl / 1e3,
                                          name="z384_sumproduct_layered"),
          "ms_per_batch": ms_zsl, "bound_ms": bms_zsl, "bound_by": bby_zsl,
          "plain_ms": plain_ms_zsl,
          "variants_ms": {name: zsl_median[name] for name in zsl_runs if name != "tracked"},
          "speedup_over_replaced": zsl_median["replaced_fused_zlane"] / ms_zsl,
          "rounds_ms": zsl_rounds, "parts_ms": zsl_parts, "occupancy": zsl_occupancy,
          "bit_errors": bit_errors_zsl, "mean_conv_iter": mean_conv_zsl, "nvidia_smi": smi})

    wide_entries = (wide_rows_phase(smi, max_err) + widest_rows_phase(smi, max_err)
                    + zlane_wide_phase(smi, max_err))
    src = "ldpc_tpu_torch/ops/csrc/fused_minsum.cu"
    return wide_entries + [
        {"name": "fused_retire", "route": "cuda",
         "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:143", "launches": launches_main["fused_retire"],
         "max_abs_err": max(max_err["fused_retire"], err_main), "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bms, "bound_by": bby, "library_ms": None},
        {"name": "retire_layered", "route": "cuda",
         "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:143",
         "launches": launches_lay["retire_layered"],
         "max_abs_err": max(max_err["retire_layered"], err_lay), "ms": ms_lay,
         "plain_ms": plain_ms_lay, "bound_ms": bms_lay, "bound_by": bby_lay,
         "library_ms": None},
        {"name": "retire_sumproduct", "route": "cuda",
         "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:143",
         "launches": launches_sp["retire_sumproduct"],
         "max_abs_err": max(max_err["retire_sumproduct"], err_sp), "ms": ms_sp,
         "plain_ms": plain_ms_sp, "bound_ms": bms_sp, "bound_by": bby_sp, "library_ms": None},
        {"name": "retire_layered_sumproduct", "route": "cuda",
         "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:143",
         "launches": launches_sl["retire_layered_sumproduct"],
         "max_abs_err": max(max_err["retire_layered_sumproduct"], err_sl), "ms": ms_sl,
         "plain_ms": plain_ms_sl, "bound_ms": bms_sl, "bound_by": bby_sl, "library_ms": None},
        # fused serves rows over 121 members (launches: the wide-row compare
        # cases); its ms is sum-product flooding through the side door,
        # _launch_fused, on the sumproduct phase's batch, which bound_ms and
        # plain_ms count.
        {"name": "fused", "route": "cuda", "source": src,
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:143", "launches": launches_wide["fused"],
         "max_abs_err": max_err["fused"], "ms": sp_median["replaced_fused"],
         "ms_of": "sum-product flooding through _launch_fused (side door)",
         "plain_ms": plain_ms_sp, "bound_ms": bms_sp, "bound_by": bby_sp, "library_ms": None},
        {"name": "retire_zlane", "route": "cuda",
         "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:399", "launches": launches_z["retire_zlane"],
         "max_abs_err": max(max_err["retire_zlane"], err_z), "ms": ms384,
         "plain_ms": plain_ms384, "bound_ms": bms384, "bound_by": bby384, "library_ms": None},
        {"name": "retire_zlane_layered", "route": "cuda",
         "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:399",
         "launches": launches_zl["retire_zlane_layered"],
         "max_abs_err": max(max_err["retire_zlane_layered"], err_zl), "ms": ms_zl,
         "plain_ms": plain_ms_zl, "bound_ms": bms_zl, "bound_by": bby_zl, "library_ms": None},
        {"name": "retire_zlane_sumproduct", "route": "cuda",
         "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:399",
         "launches": launches_zs["retire_zlane_sumproduct"],
         "max_abs_err": max(max_err["retire_zlane_sumproduct"], err_zs), "ms": ms_zs,
         "plain_ms": plain_ms_zs, "bound_ms": bms_zs, "bound_by": bby_zs, "library_ms": None},
        {"name": "retire_zlane_layered_sumproduct", "route": "cuda",
         "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:399",
         "launches": launches_zsl["retire_zlane_layered_sumproduct"],
         "max_abs_err": max(max_err["retire_zlane_layered_sumproduct"], err_zsl), "ms": ms_zsl,
         "plain_ms": plain_ms_zsl, "bound_ms": bms_zsl, "bound_by": bby_zsl, "library_ms": None},
        # fused_zlane serves rows over 121 members at large Z (launches: the
        # wide-row compare cases); its ms is sum-product flooding through
        # the side door, _launch_zlane, on the z384_sumproduct phase's batch,
        # which bound_ms and plain_ms count.
        {"name": "fused_zlane", "route": "cuda", "source": src,
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:399",
         "launches": launches_wide["fused_zlane"],
         "max_abs_err": max_err["fused_zlane"],
         "ms": zs_median["replaced_fused_zlane"],
         "ms_of": "sum-product flooding through _launch_zlane (side door)",
         "plain_ms": plain_ms_zs, "bound_ms": bms_zs, "bound_by": bby_zs, "library_ms": None},
    ]


# Phase wide_rows: IEEE 802.3an's (2048, 1723) shape, a (6, 32) array of
# Z=64 circulants with every cell filled, shift (r * c) mod 64 (rows of 32
# members, columns of 6).  The SNR starts at WIDE["SNR"] and steps by
# WIDE["STEP"] until the mean conv_iter of min-sum flooding lies in
# WIDE["CONV"].
WIDE = dict(B=65536, SNR=4.0, STEP=0.5, CONV=(2.0, 8.0), llr_seed=8, iterations=20)
# Phase widest_rows: J. L. Fan's array LDPC code at p = 67, a (4, 64) array of
# 67 x 67 circulants, shift (r * c) mod 67 (rows of 64 members, columns of
# 4; n = 4288, 17,152 edges a frame).  B = 49152 frames hold 8.4e8 lifted
# edges, within 5% of wide_rows' batch; the SNR steps as wide_rows'.
WIDEST = dict(B=49152, SNR=6.0, STEP=0.5, CONV=(2.0, 8.0), llr_seed=9, iterations=20)
# Phase zlane_wide: the same two shapes at large Z, where a frame exceeds a
# block's shared memory (fused would need 393 KB of it for each) and auto
# takes fused_zlane: 802.3an's shape at Z=384 (rows of 32, n = 12288, no
# 4-cycle: |dr * dc| <= 155 < 384) on the 64-bit word, and the array shape
# at p = Z = 256 (rows of 64, n = 16384, rate 0.94; |dr * dc| <= 189 < 256)
# on the 128-bit word.  Batch 512 (3.77e7 and 3.36e7 lifted edges, against
# z384's 3.87e7); the SNR steps by 0.25 dB as wide_rows' does.
ZLANE_WIDE = dict(B=512, STEP=0.25, CONV=(2.0, 8.0), llr_seed=10, iterations=20)
ZLANE_WIDE_SNR = {64: 6.0, 128: 7.5}


def ieee_shape_base(Z: int = 64):
    """The (6, 32) base graph of Z x Z circulants, shift (r * c) mod Z in
    every cell (IEEE 802.3an's shape at Z=64)."""
    import numpy as np
    from ldpc_tpu_torch.codes import BaseGraph

    r, c = np.meshgrid(np.arange(6), np.arange(32), indexing="ij")
    return BaseGraph("ieee_6x32", (r * c) % Z)


def ieee_shape_code(Z: int = 64):
    """ieee_shape_base lifted by Z."""
    from ldpc_tpu_torch.codes import qc_layout

    return qc_layout(ieee_shape_base(Z), Z)


def array_base(p: int = 67, rows: int = 4, cols: int = 64):
    """J. L. Fan's array LDPC code: a (rows, cols) array of p x p circulants,
    shift (r * c) mod p in every cell (rows of ``cols`` members, columns of
    ``rows``); for prime p it has no 4-cycle."""
    import numpy as np
    from ldpc_tpu_torch.codes import BaseGraph

    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return BaseGraph(f"array_{rows}x{cols}_p{p}", (r * c) % p)


def array_code(p: int = 67, rows: int = 4, cols: int = 64):
    """array_base lifted by p."""
    from ldpc_tpu_torch.codes import qc_layout

    return qc_layout(array_base(p, rows, cols), p)


def wide_phases(smi: str) -> list[dict]:
    """``--only wide``: phase 3's wide-row cases, then wide_rows,
    widest_rows and zlane_wide; the kernels line's rows of the sixteen
    wider-word routes."""
    from ldpc_tpu_torch.ops import fused_minsum as fm

    max_err = {name: 0.0 for name in fm.LAUNCHES}
    wide_compare(max_err)
    return (wide_rows_phase(smi, max_err) + widest_rows_phase(smi, max_err)
            + zlane_wide_phase(smi, max_err))


def wide_rows_phase(smi: str, max_err: dict) -> list[dict]:
    """B1's four schedules on rows of 32 members through their 64-bit-word
    routes (fm.WIDE_ROUTES) at WIDE's batch (wide_phase)."""
    qc = ieee_shape_code()
    assert qc.dr_max == 32 and qc.num_edges == 12288
    return wide_phase(smi, max_err, "wide_rows", "ieee_6x32 (r*c mod 64)", qc, WIDE, 64)


def zlane_wide_phase(smi: str, max_err: dict) -> list[dict]:
    """B2's four schedules at large Z on rows of 32 members (802.3an's shape
    at Z=384) through their 64-bit-word routes (fm.ZLANE_WIDE_ROUTES) and
    on rows of 64 (the array shape at Z=256) through their 128-bit-word
    routes (fm.ZLANE_W128_ROUTES), at ZLANE_WIDE's batch (wide_phase)."""
    ieee, array = ieee_shape_code(384), array_code(256)
    assert (ieee.dr_max, ieee.num_vars, ieee.num_edges) == (32, 12288, 73728)
    assert (array.dr_max, array.num_vars, array.num_edges) == (64, 16384, 65536)
    return (wide_phase(smi, max_err, "zlane_wide", "ieee_6x32 (r*c mod 384) Z=384", ieee,
                       dict(ZLANE_WIDE, SNR=ZLANE_WIDE_SNR[64]), 64, large_z=True)
            + wide_phase(smi, max_err, "zlane_wide", "array_4x64 (r*c mod 256) Z=256", array,
                         dict(ZLANE_WIDE, SNR=ZLANE_WIDE_SNR[128]), 128, large_z=True))


def widest_rows_phase(smi: str, max_err: dict) -> list[dict]:
    """B1's four schedules on rows of 64 members through their 128-bit-word
    routes (fm.W128_ROUTES) at WIDEST's batch (wide_phase)."""
    qc = array_code()
    assert (qc.dr_max, qc.num_vars, qc.num_base_rows * qc.Z, qc.num_edges) == \
        (64, 4288, 268, 17152)
    return wide_phase(smi, max_err, "widest_rows", "array_4x64_p67 (r*c mod 67)", qc, WIDEST, 128)


def wide_phase(smi: str, max_err: dict, phase: str, label: str, qc, cfg: dict,
               word_bits: int, large_z: bool = False) -> list[dict]:
    """The four schedules on ``qc`` through their routes on the state word
    of ``word_bits`` (64: fm.WIDE_ROUTES, or fm.ZLANE_WIDE_ROUTES where
    ``large_z``; 128: fm.W128_ROUTES, fm.ZLANE_W128_ROUTES) at ``cfg``'s
    batch: launched alone, identical to the plain version (min-sum) or at
    the sum-product bars, and identical to the kernel they replaced (fused
    through _launch_fused, fused_zlane through _launch_zlane); five rounds
    beside it, each median faster than its; bounds, plans and ptxas.  At
    large Z also each route's throughput mode and B1's route on the same
    word where its plan takes the frame (``auto`` picks fused_zlane there
    for fused's full-c2v memory), timed in the same rounds.  Returns the
    kernels line's four rows."""
    from ldpc_tpu_torch.models.classical import BeliefPropagationDecoder, MinSumScaledDecoder
    from ldpc_tpu_torch.ops import fused_minsum as fm
    from ldpc_tpu_torch.utils.metrics import decode_throughput

    routes = {(64, False): fm.WIDE_ROUTES, (128, False): fm.W128_ROUTES,
              (64, True): fm.ZLANE_WIDE_ROUTES, (128, True): fm.ZLANE_W128_ROUTES}[
        word_bits, large_z]
    build = fm.make_fused_minsum_zlane if large_z else fm.make_fused_minsum
    replaced = "replaced_fused_zlane" if large_z else "replaced_fused"
    B, T, n = cfg["B"], cfg["iterations"], qc.num_vars
    alpha = {"minsum": 0.75, "sumproduct": 1.0}
    decs = {f"{mode} {sched}": build(qc, T, alpha[mode], mode=mode, schedule=sched)
            for mode, sched in WIDE_SCHEDULES}
    for (mode, sched), dec in zip(WIDE_SCHEDULES, decs.values()):
        assert (dec.mode, dec.schedule) == (mode, sched) and dec.route in routes
    # The SNR: steps until min-sum flooding's mean conv_iter lies in CONV
    # (the plain version's, since the two are held identical below).
    snr, steps = cfg["SNR"], {}
    first = decs["minsum flooding"]
    while True:
        llr = llrs(n, B, snr, seed=cfg["llr_seed"])
        steps[snr] = float(first(llr)[1].float().mean().item())
        if cfg["CONV"][0] <= steps[snr] <= cfg["CONV"][1] or snr >= cfg["SNR"] + 4.0:
            break
        snr += cfg["STEP"]
    if not cfg["CONV"][0] <= steps[snr] <= cfg["CONV"][1]:
        raise AssertionError(f"no SNR gives a mean conv_iter in {cfg['CONV']}: {steps}")
    # The entry points a user calls, and the launches of this phase's run.
    servers = {"minsum flooding": MinSumScaledDecoder(qc, T, 0.75, early_stopping=False),
               "minsum layered": MinSumScaledDecoder(qc, T, 0.75, early_stopping=False,
                                                     schedule="layered"),
               "sumproduct flooding": BeliefPropagationDecoder(qc, T, early_stopping=False)}
    bp = build(qc, T, 1.0, mode="sumproduct")
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    outs = {name: dec(llr) for name, dec in decs.items()}
    served = {name: server.decode(llr)[0] for name, server in servers.items()}
    bits_bp = bp(llr)[0]
    torch.cuda.synchronize()
    launches = dict(fm.LAUNCHES)
    expected = {dec.route: 1 + (name in servers) + (name == "sumproduct flooding")
                for name, dec in decs.items()}
    if {k: v for k, v in launches.items() if v} != expected:
        raise AssertionError(f"{phase} did not run its kernels alone: {launches}")
    for name, bits in list(served.items()) + [("sumproduct flooding", bits_bp)]:
        assert bool(torch.equal(bits, outs[name][0])), name
    stats, plain_ms, errs = {}, {}, {}
    for name, dec in decs.items():
        bits, conv = outs[name]
        assert bits.shape == (B, n) and conv.shape == (B,)
        plain_ms[name], plain_out = cuda_ms(lambda d=dec: d.plain(llr), reps=1)
        errs[name] = compare(dec, llr, f"{dec.route} {phase} B={B} {snr} dB", plain_out)
        stats[name] = {"identical_to_plain": bool(torch.equal(bits, plain_out[0]) and
                                                  torch.equal(conv, plain_out[1])),
                       "bit_errors": int(bits.sum().item()),
                       "frame_errors": int((bits.sum(dim=1) > 0).sum().item()),
                       "mean_conv_iter": float(conv.float().mean().item())}
        del plain_out
        max_err[dec.route] = max(max_err[dec.route], errs[name])
    # Each kernel beside the one it replaced through the side door on the
    # same batch, in five interleaved rounds; the replaced kernel's output
    # identical.  At large Z also the throughput mode, and B1's route on
    # this word (a "fused" decoder's, built past the fused kernel's own
    # shared-memory check) where its plan takes the frame, identical too.
    runs, b1_routes = {}, {}
    for (mode, sched), (name, dec) in zip(WIDE_SCHEDULES, decs.items()):
        side_door = dec._launch_zlane if large_z else dec._launch_fused
        runs[name] = {"kernel": (lambda d=dec: d(llr), 5),
                      replaced: (lambda f=side_door: f(llr), 1)}
        if large_z:
            thr = build(qc, T, alpha[mode], mode=mode, schedule=sched, track_convergence=False)
            compare(thr, llr, f"{thr.route} {phase} B={B} {snr} dB throughput mode")
            runs[name]["throughput_mode"] = (lambda d=thr: d(llr), 2)
            b1 = fm.FusedDecoder("fused", qc, T, alpha[mode], 1, mode, True, False, sched,
                                 dec.device)
            b1_routes[dec.route] = b1.route
            if b1.retire:
                runs[name]["b1_route"] = (lambda d=b1: d(llr), 2)
    settle = time.perf_counter() + 1.0
    while time.perf_counter() < settle:
        for dec in decs.values():
            dec(llr)
        torch.cuda.synchronize()
    rounds = {name: {which: [] for which in r} for name, r in runs.items()}
    for _ in range(5):
        for name, r in runs.items():
            for which, (fn, reps) in r.items():
                t, out = cuda_ms(fn, reps=reps)
                rounds[name][which].append(t)
                if which != "throughput_mode" and not (torch.equal(out[0], outs[name][0]) and
                                                       torch.equal(out[1], outs[name][1])):
                    raise AssertionError(f"{which} differs from {decs[name].route} on {phase}")
    median = {name: {w: sorted(r)[len(r) // 2] for w, r in rs.items()} for name, rs in rounds.items()}
    slower = [name for name in decs if median[name]["kernel"] >= median[name][replaced]]
    if slower:
        raise AssertionError(f"{phase} kernels not faster than the replaced kernel: {slower} "
                             f"{median}")
    bounds = {}
    for (mode, sched), (name, dec) in zip(WIDE_SCHEDULES, decs.items()):
        bound = bound_ms if mode == "minsum" else bp_bound_ms
        bounds[name] = bound(qc, outs[name][1], layered=sched == "layered")
    if large_z:
        plans = {routes[0]: fm.retire_zlane_plan(qc, True, word_bits=word_bits),
                 routes[1]: fm.retire_zlane_layered_plan(qc, True, word_bits=word_bits),
                 routes[2]: fm.retire_zlane_sumproduct_plan(qc, True, word_bits=word_bits),
                 routes[3]: fm.retire_zlane_layered_sumproduct_plan(qc, True,
                                                                    word_bits=word_bits)}
        kernels = ("retire_zlane_kernel", "retire_zlane_layered_kernel",
                   "retire_zlane_sumproduct_kernel", "retire_zlane_layered_sumproduct_kernel")
    else:
        plans = {routes[0]: fm.retire_plan(qc, True, word_bits=word_bits),
                 routes[1]: fm.retire_layered_plan(qc, True, word_bits=word_bits),
                 routes[2]: fm.retire_sumproduct_plan(qc, True, word_bits=word_bits),
                 routes[3]: fm.retire_layered_sumproduct_plan(qc, True, word_bits=word_bits)}
        kernels = ("retire_minsum_kernel", "retire_layered_kernel", "retire_sumproduct_kernel",
                   "retire_layered_sumproduct_kernel")
    # The instantiations on this word: template argument y (unsigned long
    # long) or the Word128 struct.
    word, width = ("EyE", 12) if word_bits == 64 else ("Word128", 40)
    ptxas = {route: {k: v for k, v in ptxas_of("fused_retire", kernel, width).items() if word in k}
             for route, kernel in zip(routes, kernels)}
    others = [w for w in ("throughput_mode", "b1_route") if any(w in m for m in median.values())]
    emit({"phase": phase, "code": label, "Z": qc.Z, "n": n,
          "edges": qc.num_edges, "batch": B, "iterations": T, "snr_db": snr,
          "snr_steps_mean_conv_iter": steps, "launches": launches,
          "ms_per_batch": {decs[k].route: m["kernel"] for k, m in median.items()},
          f"{replaced}_ms": {decs[k].route: m[replaced] for k, m in median.items()},
          "speedup_over_replaced": {decs[k].route: m[replaced] / m["kernel"]
                                    for k, m in median.items()},
          **{f"{w}_ms": {decs[k].route: m.get(w) for k, m in median.items()} for w in others},
          "b1_routes": b1_routes or None,
          "bits_per_s": {decs[k].route: decode_throughput(B, n, m["kernel"] / 1e3, name=phase)
                         for k, m in median.items()},
          "bound_ms": {decs[k].route: b for k, b in bounds.items()},
          "plain_ms": {decs[k].route: t for k, t in plain_ms.items()},
          "rounds_ms": {decs[k].route: r for k, r in rounds.items()},
          "decode": {decs[k].route: v for k, v in stats.items()},
          "plans": plans, "ptxas": ptxas, "nvidia_smi": smi})
    return [{"name": dec.route, "route": "cuda",
             "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
             "replaces": f"ldpc_tpu/ops/pallas_minsum.py:{399 if large_z else 143}",
             "launches": launches[dec.route], "max_abs_err": max_err[dec.route],
             "ms": median[name]["kernel"], "plain_ms": plain_ms[name],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
            for name, dec in decs.items()]


# ---------------------------------------------------------------------------
# The corrected min-sum GNN path
# ---------------------------------------------------------------------------

GNN_SOFT_ATOL = 2e-2  # soft bits, kernel vs plain version, frames with equal conv_iter
GNN_MIN_BIT_AGREEMENT = 0.999
GNN_MIN_CONV_AGREEMENT = 0.99
GNN_MODULE_ATOL = 3e-2  # fixed-T kernel vs the module's forward
# The noise floor's T=1 bar by kernel (gnn_phases): no flip cascades there.
# corrected's sits between what a reordering alone moves there (the noise
# floor's plain_vs_plain_reordered) and what a kernel that drops one bf16
# rounding moves (PERF.md, PR 13; on the CPU,
# tests/test_torch_corrected_v1_tc.py::test_depth1_bar_separates_order_from_rounding).
GNN_DEPTH1_ATOL = {"corrected_v2": 1e-5, "corrected": 1e-4}
# Mean conv_iter the JAX package records for the same checkpoints, batch and
# SNR (BENCH_r05.json: iteration counts, not speeds), and the window held.
GNN_MEAN_CONV = {10: 4.45, 20: 3.86}
GNN_MEAN_CONV_WINDOW = 0.5
# gnn_main: nr_2_0_32 Z=32, the trained checkpoints of results/ by T.
GNN_MAIN = dict(H=64, B=2048, SNR=0.0, llr_seed=2)
GNN_CHECKPOINTS = {10: "corrected10_gnn_nr_2_0_32_ft3.msgpack",
                   20: "corrected20_gnn_nr_2_0_32_ft.msgpack"}
# bench.py section_corrected_gnn (bench.py:227-266).
GNN_BENCH = dict(code="nr_2_0_4", Z=4, H=64, T=5, B=4096, SNR=3.0, llr_seed=3,
                 checkpoint="corrected_gnn_nr_2_0_4.msgpack")


def gnn_bound_ms(qc, h: int, inject: bool, kind: str, conv: torch.Tensor) -> tuple[float, str]:
    """Least time for this batch's corrected-GNN decode, derived in the header
    of ldpc_tpu_torch/ops/csrc/fused_gnn_tc.cu ("The bound of both kernels"):
    products at the dense bf16 tensor-core rate, elementwise and min-sum work
    at the float32 rate, LLRs read and soft bits written once; a frame needs
    conv_iter iterations and 2 conv_iter - 1 corrections."""
    E, n, M = qc.num_edges, qc.num_vars, qc.num_base_rows * qc.Z
    inj = int(inject)
    iterations = float(conv.sum().item())
    corrections = float((2 * conv - 1).sum().item())
    first = 2 * h * h * (2 * E + (1 + 2 * inj) * n + M)
    if kind == "corrected_v2":
        products = first + 4 * h * E
        elementwise = (8 + inj) * h * E + (2 + 3 * inj) * h * n + 3 * h * M + E
    else:
        products = first + (4 * h * h + 2 * h) * E
        elementwise = (15 + inj) * h * E + (1 + 3 * inj) * h * n + h * M + E
    t_tensor = corrections * products / PEAK_BF16_TENSOR_OPS
    t_f32 = ((corrections * elementwise + iterations * (12 * E + 4 * M + 2 * n)) / PEAK_F32_OPS
             + iterations * (E + M) / PEAK_I32_OPS)
    t_bytes = conv.shape[0] * (8 * n + 4) / PEAK_BYTES
    t_ops = max(t_tensor, t_f32)
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")


def gnn_compare(dec, llr: torch.Tensor, label: str, phase: str = "gnn_compare",
                kernel_out=None, plain_out=None) -> float:
    """A corrected-GNN kernel against its plain version on the card
    (``kernel_out``, ``plain_out``: their results on ``llr``, if already at
    hand); returns the max |soft difference| over frames whose conv_iter
    agrees."""
    out_k = kernel_out if kernel_out is not None else dec(llr)
    out_p = plain_out if plain_out is not None else dec.plain(llr)
    torch.cuda.synchronize()
    if dec.return_iterations:
        (soft_k, conv_k), (soft_p, conv_p) = out_k, out_p
    else:
        soft_k, soft_p = out_k, out_p
        conv_k = conv_p = torch.full((llr.shape[0],), float(dec.num_iterations), device=llr.device)
    assert soft_k.shape == soft_p.shape == llr.shape and soft_k.dtype == torch.float32, label
    assert bool(torch.isfinite(soft_k).all()) and float(soft_k.min()) >= 0.0 \
        and float(soft_k.max()) <= 1.0, label
    same = conv_k == conv_p
    conv_agreement = same.float().mean().item()
    bit_agreement = ((soft_k > 0.5) == (soft_p > 0.5)).float().mean().item()
    err = (soft_k - soft_p)[same].abs().max().item() if bool(same.any()) else 0.0
    ok = (err <= GNN_SOFT_ATOL and bit_agreement >= GNN_MIN_BIT_AGREEMENT
          and conv_agreement >= GNN_MIN_CONV_AGREEMENT)
    emit({"phase": phase, "case": label, "frames": llr.shape[0], "max_abs_err": err,
          "bit_agreement": bit_agreement, "conv_agreement": conv_agreement,
          "mean_conv_iter": conv_k.mean().item(), "ok": ok})
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {label}")
    return err


def checkpoint_model(plan, T: int, h: int, name: str):
    """A corrected decoder with injection loaded from results/<name> by the
    port's own msgpack reader (a missing file raises)."""
    from ldpc_tpu_torch import convert
    from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder

    model = create_corrected_minsum_gnn_decoder(plan, num_iterations=T, hidden_dim=h,
                                                input_injection=True)
    convert.load_message_gnn(Path(__file__).resolve().parent / "results" / name, model)
    return model


def trace_gnn() -> dict:
    """One corrected_v2 decode of the gnn_main batch (T=10) under the profiler."""
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_gnn as fg, qc_msg

    m = GNN_MAIN
    qc = qc_layout(get_base_graph("nr_2_0_32"), 32)
    model = checkpoint_model(qc_msg.make_plan(qc), 10, m["H"], GNN_CHECKPOINTS[10])
    llr = llrs(qc.num_vars, m["B"], m["SNR"], seed=m["llr_seed"])
    dec = fg.make_fused_corrected_gnn_decoder_v2(qc, model, 10, m["H"], input_injection=True,
                                                 early_exit=True, return_iterations=True)
    dec(llr)  # warm-up: the plan and the first launch
    return {"phase": "trace_gnn", "kernel": "corrected_v2", "iterations": 10, "batch": m["B"],
            **trace_split(lambda: dec(llr), "gnn")}


def add_noise(model, scale: float, gen: torch.Generator):
    """Every parameter of ``model`` moved by scale * normal noise from ``gen``."""
    with torch.no_grad():
        for param in model.parameters():
            param.add_((scale * torch.randn(param.shape, generator=gen)).to(param.device))
    return model


def perturbed_model(plan, T: int, h: int, inject: bool, share: bool, scale: float, seed: int):
    """A corrected decoder with trained-like parameters: initialised from a
    seed, then every parameter moved by scale * normal noise, so that the
    projections are non-zero and the corrections matter."""
    from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder

    gen = torch.Generator().manual_seed(seed)
    model = create_corrected_minsum_gnn_decoder(plan, num_iterations=T, hidden_dim=h,
                                                input_injection=inject, share_layers=share,
                                                generator=gen)
    return add_noise(model, scale, gen)


def gnn_phases(smi: str) -> list[dict]:
    from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix, get_base_graph, qc_layout
    from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder
    from ldpc_tpu_torch.ops import fused_gnn as fg, fused_minsum as fm, qc_msg
    from ldpc_tpu_torch.ops.msg_gnn_exact import CORRECTED_EXACT_CASES, exact_corrected_case
    from ldpc_tpu_torch.utils import bpsk_awgn_llr, compute_ber_fer
    from ldpc_tpu_torch.utils.metrics import decode_throughput

    tc_lib = fg.corrected_tc_library()
    builders = {"corrected_v2": fg.make_fused_corrected_gnn_decoder_v2,
                "corrected": fg.make_fused_corrected_gnn_decoder}
    max_err = {kind: 0.0 for kind in builders}

    # 6. gnn_compare
    # Frames at three SNRs each, so that some stop after one iteration, some
    # after two and some never.  The parameter noise is smaller at h=64: the
    # bf16 steps grow with the activations, and with them what one flipped
    # rounding moves.
    for code, Z, h, B, snrs, scale in (("toy_4x8", 4, 16, 37, (1.0, 3.0, 6.0), 0.05),
                                       ("nr_2_0_4", 4, 64, 21, (1.0, 4.0, 7.0), 0.02),
                                       ("nr_2_0_32", 32, 64, 13, (1.0, 4.0, 7.0), 0.02)):
        qc = qc_layout(get_base_graph(code), Z)
        plan = qc_msg.make_plan(qc)
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        llr = torch.cat([llrs(qc.num_vars, len(range(i, B, 3)), snr, seed=Z + h + i)
                         for i, snr in enumerate(snrs)])
        cases = [(inject, False, ee) for inject in (True, False) for ee in (False, True)]
        cases.append((True, True, True))  # share_layers once
        # the wrappers' shared-memory plans are the kernels'
        for kind, inject, warps in itertools.product(builders, (False, True), (1, 5, 12)):
            assert tc_lib.ldpc_corrected_tc_smem_bytes(
                int(kind == "corrected"), h, int(inject), *dims, qc.num_edge_types, warps) \
                == fg.corrected_smem_bytes(kind, qc, h, inject, warps)
        for kind, build in builders.items():
            for inject, share, ee in cases:
                model = perturbed_model(plan, 2, h, inject, share, scale, seed=7)
                dec = build(qc, model, 2, h, share_layers=share, input_injection=inject,
                            early_exit=ee, return_iterations=ee)
                label = (f"{kind} {code} Z={Z} h={h} B={B} T=2 inject={inject} "
                         f"share={share} early_exit={ee}")
                max_err[kind] = max(max_err[kind], gnn_compare(dec, llr, label))

    # Exact inputs (ops/msg_gnn_exact.py): every sum either kernel reorders is
    # exact in any order, so it must equal its plain version bit for bit.
    for (code, Z, h, B, inject, share, ee), (kind, build) in itertools.product(
            CORRECTED_EXACT_CASES, builders.items()):
        qc = qc_layout(get_base_graph(code), Z)
        model, llr_np = exact_corrected_case(qc, h, B, inject, share)
        dec = build(qc, model, 2, h, share_layers=share, input_injection=inject, early_exit=ee,
                    return_iterations=ee)
        llr = torch.from_numpy(llr_np).cuda()
        out_k, out_p = dec(llr), dec.plain(llr)
        torch.cuda.synchronize()
        (soft_k, conv_k), (soft_p, conv_p) = (out_k, out_p) if ee else ((out_k, None),
                                                                       (out_p, None))
        ok = bool(torch.equal(soft_k, soft_p)) and (not ee or bool(torch.equal(conv_k, conv_p)))
        emit({"phase": "gnn_compare", "case": f"{kind} exact {code} Z={Z} h={h} B={B} "
              f"inject={inject} share={share} early_exit={ee}", "identical": ok,
              "max_abs_err": (soft_k - soft_p).abs().max().item(),
              "ones_share": (soft_p > 0.5).float().mean().item(),
              "conv_iter": conv_p.tolist() if ee else None, "ok": ok})
        if not ok:
            raise AssertionError(f"{kind} differs from its plain version on exact inputs: "
                                 f"{code} Z={Z} h={h} inject={inject} share={share} "
                                 f"early_exit={ee}")

    # The noise floor of that comparison, at nr_2_0_32 Z=32 h=64: beside the
    # kernel against the plain version, two witnesses of what a change of
    # float32 summation order alone moves: the plain version on the card
    # against itself on the CPU (another order inside torch.matmul, where the
    # libraries differ), and the plain version against itself with its hidden
    # units permuted (every product and the projection summed in another
    # order; the largest of three permutations).  At T=1 a single correction
    # reaches the output and no flipped bf16 rounding can cascade.  There
    # corrected_v2, whose one rounding after a reordered sum is bf16(relu(.))
    # ahead of its folded thin product, is held within 1e-5; corrected rounds
    # three times more after its reordered second-layer sums (out_v, out_c and
    # their sum, each then times pw), so one flipped rounding moves a soft bit
    # by |pw_j| times a bf16 step of lo_j times p(1 - p), and it is held within
    # GNN_DEPTH1_ATOL (1e-4), set from these witnesses and from planted
    # rounding faults (PERF.md, PR 13).  At T=2 both within the bar above.  T=3
    # is beyond that bar and is measured, not held to it: one model of three
    # iterations decoded to depth 1, 2 and 3 (a decoder of depth d runs the
    # model's first d iterations), which shows the iteration at which kernel and
    # plain version first differ by more than 1e-5, how the error grows from
    # there, and what share of the outputs it touches.  Held at every depth:
    # decisions equal on >= 99.9% of bits.
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    plan32 = qc_msg.make_plan(qc32)
    n = qc32.num_vars
    llr = llrs(n, 3, 3.0, seed=32)
    model = perturbed_model(plan32, 3, 64, True, False, 0.02, seed=7)
    for kind, build in builders.items():
        by_depth, first_differing = [], None
        for depth in (1, 2, 3):
            dec = build(qc32, model, depth, 64, input_injection=True)
            soft_k, soft_p = dec(llr), dec.plain(llr)
            soft_cpu = build(qc32, model, depth, 64, input_injection=True, device="cpu")(llr.cpu())
            diff = (soft_k - soft_p).abs()
            err = diff.max().item()
            floor = (soft_p - soft_cpu.to(llr.device)).abs().max().item()
            reordered = max(
                (dec.plain_reordered(llr, torch.randperm(64, generator=torch.Generator()
                                                         .manual_seed(seed))) - soft_p)
                .abs().max().item() for seed in (1, 2, 3))
            agreement = ((soft_k > 0.5) == (soft_p > 0.5)).float().mean().item()
            if first_differing is None and err > 1e-5:
                first_differing = depth
            by_depth.append({"iterations": depth, "max_abs_err": err,
                             "plain_card_vs_plain_cpu": floor,
                             "err_over_floor": err / floor if floor > 0 else None,
                             "plain_vs_plain_reordered": reordered,
                             "outputs_above_1e-3": (diff > 1e-3).float().mean().item(),
                             "bit_agreement": agreement})
            bar = {1: GNN_DEPTH1_ATOL[kind], 2: GNN_SOFT_ATOL}.get(depth)
            if agreement < GNN_MIN_BIT_AGREEMENT or (bar is not None and err > bar):
                raise AssertionError(f"{kind} kernel disagrees with its plain version at "
                                     f"{depth} iterations: {by_depth[-1]}")
            if bar is not None:
                max_err[kind] = max(max_err[kind], err)
        emit({"phase": "gnn_compare", "case": f"noise floor {kind} nr_2_0_32 h=64",
              "first_iteration_differing": first_differing, "by_depth": by_depth, "ok": True})

    # 7. gnn_zero_init: untrained corrections are zero -> exactly min-sum
    T0, B0 = 10, 512
    llr = llrs(n, B0, 1.5, seed=11)
    bits_ms, conv_ms = fm.make_fused_minsum(qc32, T0, 0.8, early_exit=True)(llr)
    untrained = create_corrected_minsum_gnn_decoder(
        plan32, num_iterations=T0, hidden_dim=64, input_injection=True,
        generator=torch.Generator().manual_seed(5))
    for kind, build in builders.items():
        soft, conv = build(qc32, untrained, T0, 64, early_exit=True, return_iterations=True)(llr)
        torch.cuda.synchronize()
        bits_same = bool(torch.equal((soft > 0.5).float(), bits_ms))
        conv_same = bool(torch.equal(conv, conv_ms.float()))
        emit({"phase": "gnn_zero_init", "kernel": kind, "batch": B0, "iterations": T0,
              "bits_identical": bits_same, "conv_iter_identical": conv_same,
              "mean_conv_iter": conv.mean().item(),
              "converged_share": (conv < T0).float().mean().item()})
        if not (bits_same and conv_same):
            raise AssertionError(f"untrained {kind} kernel is not the fused min-sum decoder")

    # 8. gnn_main: trained checkpoints, nr_2_0_32 Z=32 h=64, batch 2048, 0 dB
    H, B, SNR, HARD_SNR = GNN_MAIN["H"], GNN_MAIN["B"], GNN_MAIN["SNR"], -3.0
    llr = llrs(n, B, SNR, seed=GNN_MAIN["llr_seed"])
    llr_hard = llrs(n, 64, HARD_SNR, seed=9)
    entries = []
    models = {T: checkpoint_model(plan32, T, H, name) for T, name in GNN_CHECKPOINTS.items()}
    runs = (("corrected_v2", 10, True), ("corrected_v2", 20, False), ("corrected", 10, True))
    decoders = {(kind, T): builders[kind](qc32, models[T], T, H, input_injection=True,
                                          early_exit=True, return_iterations=True)
                for kind, T, _ in runs}
    # corrected_v2 (the kernel bench.py's corrected sections serve) and
    # corrected: five rounds, the three runs interleaved, the median as the time.
    rounds_ms = {(kind, T): [] for kind, T, _ in runs}
    for _ in range(5):
        for key in rounds_ms:
            rounds_ms[key].append(cuda_ms(lambda: decoders[key](llr), reps=2)[0])
    for kind, T, in_kernels_line in runs:  # the T=20 run is an extra reading of corrected_v2
        dec = decoders[(kind, T)]
        for key in fg.LAUNCHES:
            fg.LAUNCHES[key] = 0
        counted_out = dec(llr)
        soft, conv = counted_out
        torch.cuda.synchronize()
        launches = dict(fg.LAUNCHES)
        if launches[kind] != 1:
            raise AssertionError(f"gnn main path did not run the {kind} kernel: {launches}")
        assert soft.shape == (B, n) and conv.shape == (B,) and conv.dtype == torch.float32
        assert bool(torch.isfinite(soft).all()) and float(soft.min()) >= 0.0 \
            and float(soft.max()) <= 1.0
        mean_conv = conv.mean().item()
        if abs(mean_conv - GNN_MEAN_CONV[T]) > GNN_MEAN_CONV_WINDOW:
            raise AssertionError(f"{kind} T={T}: mean conv_iter {mean_conv} is outside "
                                 f"{GNN_MEAN_CONV[T]} +- {GNN_MEAN_CONV_WINDOW}")
        ms = sorted(rounds_ms[(kind, T)])[2]
        # The counted launch's whole batch against the plain version's timed run
        # on the same batch: the shape at which the kernel is timed, every block
        # walking many frames.
        plain_ms, plain_out = cuda_ms(lambda: dec.plain(llr), reps=1)
        err = gnn_compare(dec, llr, f"{kind} main path T={T} whole batch", phase="gnn_main",
                          kernel_out=counted_out, plain_out=plain_out)
        del plain_out
        # At 0 dB nearly every frame stops and emits 0/1 decisions; at HARD_SNR
        # about half the frames run all T iterations and emit soft values.
        err = max(err, gnn_compare(dec, llr_hard, f"{kind} T={T} {HARD_SNR} dB, 64 frames",
                                   phase="gnn_main"))
        # A frame that stopped did so on a valid syndrome: hold that with the
        # tensor-op syndrome check, which shares nothing with the kernel.
        stopped = conv < T
        valid = qc_msg.syndrome_ok(qc_msg.llr_to_cz((soft[stopped] > 0.5).float(), plan32), plan32)
        if not bool(valid.all()):
            raise AssertionError(f"{kind} T={T}: a stopped frame is no codeword")
        bms, bby = gnn_bound_ms(qc32, H, True, kind, conv)
        # all-zero codewords: decisions of 1 are errors
        hard = (soft > 0.5).float()
        emit({"phase": "gnn_main", "kernel": kind, "checkpoint": GNN_CHECKPOINTS[T],
              "code": "nr_2_0_32", "Z": 32, "hidden_dim": H, "iterations": T, "batch": B,
              "snr_db": SNR, "launches": launches, "ms_per_batch": ms,
              "rounds_ms": rounds_ms[(kind, T)],
              "bits_per_s": decode_throughput(B, n, ms / 1e3, name=f"{kind}_T{T}"),
              "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
              "bound_share": bms / ms,
              "mean_conv_iter": mean_conv, "converged_share": (conv < T).float().mean().item(),
              "ber_zero_codeword": hard.mean().item(),
              "fer_zero_codeword": (hard.sum(dim=1) > 0).float().mean().item(),
              **tc_shape(qc32, H, True, kind),
              "nvidia_smi": smi})
        if in_kernels_line:
            entries.append({
                "name": kind, "route": "cuda", "source": "ldpc_tpu_torch/ops/csrc/fused_gnn_tc.cu",
                "replaces": "ldpc_tpu/ops/pallas_gnn.py:" + ("1791" if kind == "corrected_v2"
                                                            else "1341"),
                "launches": launches[kind], "max_abs_err": max(max_err[kind], err), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None})
        if kind == "corrected_v2" and T == 10:
            emit(trace_in_child("gnn"))

    # The fixed-T kernel against the module's own forward (bf16) on the main
    # path's LLRs and on the hard ones, within the JAX package's bar.
    model = models[10]
    fixed = fg.make_fused_corrected_gnn_decoder_v2(qc32, model, 10, H, input_injection=True)
    module_err = {}
    for label, x in (("main", llr[:64]), ("hard", llr_hard)):
        with torch.no_grad():
            soft_module, _ = model(x, plan32)
        soft_fixed = fixed(x)
        torch.cuda.synchronize()
        module_err[label] = {
            "max_abs_err": (soft_fixed - soft_module).abs().max().item(),
            "bit_agreement": ((soft_fixed > 0.5) == (soft_module > 0.5)).float().mean().item(),
            "frames_in_error": ((soft_module > 0.5).sum(dim=1) > 0).float().mean().item()}
    # BER / FER on GF(2)-encoded random codewords (the all-zero codeword
    # misleads for this family, which is not sign-symmetric).
    enc = encoder_from_H(expand_base_matrix(get_base_graph("nr_2_0_32"), 32))
    gen = torch.Generator(device="cuda").manual_seed(4)
    tx = enc.random_codewords(gen, B)
    early = fg.make_fused_corrected_gnn_decoder_v2(qc32, model, 10, H, input_injection=True,
                                                   early_exit=True, return_iterations=True)
    CODEWORD_SNR = -2.0
    soft_tx, conv_tx = early(bpsk_awgn_llr(gen, tx, CODEWORD_SNR))
    ber, fer = (float(x) for x in compute_ber_fer(tx, (soft_tx > 0.5).float()))
    ok = (max(e["max_abs_err"] for e in module_err.values()) <= GNN_MODULE_ATOL
          and min(e["bit_agreement"] for e in module_err.values()) >= GNN_MIN_BIT_AGREEMENT
          and fer < 0.2)
    emit({"phase": "gnn_main", "case": "fixed T=10 corrected_v2 vs MessageGNNDecoder forward, "
          "64 frames", "snr_db": {"main": SNR, "hard": HARD_SNR}, "module": module_err,
          "random_codewords": {"snr_db": CODEWORD_SNR, "batch": B, "ber": ber, "fer": fer,
                               "mean_conv_iter": conv_tx.mean().item()}, "ok": ok})
    if not ok:
        raise AssertionError("corrected_v2 disagrees with the module, or does not decode")

    # 8b. gnn_bench_nr_2_0_4: bench.py section_corrected_gnn.
    g = GNN_BENCH
    qc4 = qc_layout(get_base_graph(g["code"]), g["Z"])
    model4 = checkpoint_model(qc_msg.make_plan(qc4), g["T"], g["H"], g["checkpoint"])
    dec4 = fg.make_fused_corrected_gnn_decoder_v2(qc4, model4, g["T"], g["H"],
                                                  input_injection=True, early_exit=True,
                                                  return_iterations=True)
    llr4 = llrs(qc4.num_vars, g["B"], g["SNR"], seed=g["llr_seed"])
    for key in fg.LAUNCHES:
        fg.LAUNCHES[key] = 0
    out4 = dec4(llr4)
    torch.cuda.synchronize()
    launches = dict(fg.LAUNCHES)
    if launches["corrected_v2"] != 1:
        raise AssertionError(f"the nr_2_0_4 bench configuration did not run corrected_v2: "
                             f"{launches}")
    rounds4 = [cuda_ms(lambda: dec4(llr4), reps=3)[0] for _ in range(5)]
    ms4 = sorted(rounds4)[2]
    plain_ms4, plain4 = cuda_ms(lambda: dec4.plain(llr4), reps=1)
    err4 = gnn_compare(dec4, llr4, f"corrected_v2 {g['code']} Z={g['Z']} T={g['T']} whole batch "
                       f"of {g['B']}", phase="gnn_bench_nr_2_0_4", kernel_out=out4,
                       plain_out=plain4)
    soft4, conv4 = out4
    bms4, bby4 = gnn_bound_ms(qc4, g["H"], True, "corrected_v2", conv4)
    hard4 = (soft4 > 0.5).float()
    emit({"phase": "gnn_bench_nr_2_0_4", "kernel": "corrected_v2", "checkpoint": g["checkpoint"],
          "code": g["code"], "Z": g["Z"], "hidden_dim": g["H"], "iterations": g["T"],
          "batch": g["B"], "snr_db": g["SNR"], "launches": launches, "ms_per_batch": ms4,
          "rounds_ms": rounds4,
          "bits_per_s": decode_throughput(g["B"], qc4.num_vars, ms4 / 1e3, name="corrected_gnn"),
          "plain_ms": plain_ms4, "bound_ms": bms4, "bound_by": bby4, "bound_share": bms4 / ms4,
          "mean_conv_iter": conv4.mean().item(), "ber_zero_codeword": hard4.mean().item(),
          "fer_zero_codeword": (hard4.sum(dim=1) > 0).float().mean().item(),
          **tc_shape(qc4, g["H"], True, "corrected_v2"), "nvidia_smi": smi})
    entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"], err4)
    return entries


# ---------------------------------------------------------------------------
# The trained neural min-sum path
# ---------------------------------------------------------------------------

# OMS(10, per-iter) on nr_2_0_32 Z=32 at -3 dB, QPSK, GF(2)-encoded random
# codewords, 1.0e9 bits (results/README.md, table row -3 dB), and the window held.
NMS_BER_REF = 8.89e-3
NMS_BER_WINDOW = 0.05
NMS_UNIT_MIN_AGREEMENT = 0.9999


def nms_bound_ms(qc, T: int, L: int, B: int) -> tuple[float, str]:
    """Least time for a batch of the trained min-sum decode, derived in the
    header of ldpc_tpu_torch/ops/csrc/fused_neural.cu: T check halves and
    T - 1 variable halves of float32 work (none an FMA), LLRs read and bits
    written once."""
    E, M, n = qc.num_edges, qc.num_base_rows * qc.Z, qc.num_vars
    ops = T * (7 * E + 8 * M) + (T - 1) * (4 + 2 * L) * E + E + 2 * n
    t_ops = B * ops / PEAK_F32_OPS * 1e3
    t_bytes = (B * n * 8 + T * E * 4) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def perturbed_nms(plan, seed: int, scale: float = 0.1, **kw):
    """A NeuralMinSumDecoder with every parameter moved by scale * normal
    noise from a seed, so that weights, taps, alpha and offset all matter."""
    from ldpc_tpu_torch.models import NeuralMinSumDecoder

    model = NeuralMinSumDecoder(plan, **kw)
    gen = torch.Generator().manual_seed(seed)
    return add_noise(model, scale, gen)


def _gf2_inverse(M: np.ndarray) -> np.ndarray:
    """The inverse of a square binary matrix over GF(2), by Gauss-Jordan on
    rows packed into uint64 words; raises if it is singular."""
    import numpy as np

    n = M.shape[0]
    A = np.packbits(np.concatenate([M, np.eye(n, dtype=np.uint8)], axis=1), axis=1,
                    bitorder="little")
    A = np.pad(A, ((0, 0), (0, -A.shape[1] % 8))).view(np.uint64)
    for c in range(n):
        col = (A[:, c // 64] >> np.uint64(c % 64)) & np.uint64(1)
        rows = np.nonzero(col[c:])[0]
        if rows.size == 0:
            raise ValueError("the code's core parity block is singular")
        pr = c + rows[0]
        A[[c, pr]] = A[[pr, c]]
        col[[c, pr]] = col[[pr, c]]
        col[c] = 0
        A[col == 1] ^= A[c]
    bits = np.unpackbits(A.view(np.uint8), axis=1, bitorder="little")
    return bits[:, n:2 * n]


def nr_codewords(base, Z: int, gen: torch.Generator, B: int) -> torch.Tensor:
    """(B, C*Z) uniformly random codewords of a 5G NR base graph lifted by
    Z, as float32 bits on ``gen``'s device, encoded from its structure: C -
    R information columns, a core of 4 rows and 4 parity columns solved
    with the core's inverse over GF(2), then each extension row's own
    parity column (shift 0) from the columns before it.  A circulant of
    shift s maps block x to y[i] = x[(i + s) mod Z] (expand_base_matrix)."""
    import numpy as np

    S = np.asarray(base.shifts)
    R, C = S.shape
    kb, g = C - R, 4
    if (S[:g, kb + g:] >= 0).any() or any(
            S[r, kb + r] != 0 or (S[r, kb + r + 1:] >= 0).any() for r in range(g, R)):
        raise ValueError(f"{base.name} is not of the 5G NR form")
    dev = gen.device
    x = torch.zeros((B, C, Z), device=dev)
    x[:, :kb] = torch.randint(0, 2, (B, kb, Z), generator=gen, device=dev).to(torch.float32)

    def row_sum(r: int, cols) -> torch.Tensor:
        out = torch.zeros((B, Z), device=dev)
        for c in cols:
            if S[r, c] >= 0:
                out = out + torch.roll(x[:, c], -int(S[r, c] % Z), dims=1)
        return out

    core = np.zeros((g * Z, g * Z), np.uint8)
    i = np.arange(Z)
    for r in range(g):
        for c in range(g):
            if S[r, kb + c] >= 0:
                core[r * Z + i, c * Z + (i + S[r, kb + c]) % Z] = 1
    inv = torch.from_numpy(_gf2_inverse(core).astype(np.float32)).to(dev)
    lam = torch.cat([row_sum(r, range(kb)) for r in range(g)], dim=1) % 2
    x[:, kb:kb + g] = ((lam @ inv.T) % 2).reshape(B, g, Z)
    for r in range(g, R):
        x[:, kb + r] = row_sum(r, range(kb + r)) % 2
    for r in range(R):
        if (row_sum(r, range(C)) % 2).any():
            raise AssertionError(f"a codeword of {base.name} at Z={Z} violates row {r}")
    return x.reshape(B, C * Z)


# The mangled template argument of each state word (unsigned, unsigned long
# long, the Word128 struct), and the run-time-depth form's L = -1.
WORD_TAG = {32: "jE", 64: "yE", 128: "Word128"}
RUN_TIME_DEPTH_TAG = "Lin1E"


def group_ptxas(layout: int, word_bits: int, run_time_depth: bool) -> dict:
    """ptxas registers and spills of neural_group's instantiations in
    ``layout`` (neural_group_kernel, or neural_group_slice_kernel) on the
    state word of ``word_bits`` (built from its own source), of the
    run-time-depth form or of the forms of their own depth."""
    from ldpc_tpu_torch.ops import fused_neural as fn

    kernel = "neural_group_slice_kernel" if layout else "neural_group_kernel"
    return {k: v for k, v in ptxas_of(fn.GROUP_STEMS[word_bits], kernel, 40).items()
            if WORD_TAG[word_bits] in k and (RUN_TIME_DEPTH_TAG in k) == run_time_depth}


def routed_launch(dec, llr: torch.Tensor, counters: dict) -> torch.Tensor:
    """``dec(llr)`` with every launch counter set to 0 just before and read
    just after: the decoder's route launched once, no other kernel."""
    for key in counters:
        counters[key] = 0
    out = dec(llr)
    torch.cuda.synchronize()
    if counters[dec.route] != 1 or sum(counters.values()) != 1:
        raise AssertionError(f"a {dec.route} decode launched {counters}")
    return out


def nms_phases(smi: str) -> list[dict]:
    from ldpc_tpu_torch import convert
    from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix, get_base_graph, qc_layout
    from ldpc_tpu_torch.models import NeuralMinSumDecoder
    from ldpc_tpu_torch.ops import fused_minsum as fm, fused_neural as fn, qc_msg
    from ldpc_tpu_torch.utils import compute_ber_fer, qpsk_awgn_llr
    from ldpc_tpu_torch.utils.metrics import decode_throughput

    lib = fn.kernel_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # nms_compare: every weight sharing, depth 0-3, alpha and offset shared
    # and per iteration, perturbed parameters, each through its route: Z=4,
    # Z=12 (a warp holds 8 and 2 frames side by side), Z=32 and Z=128 (a
    # slice form) on neural_group (held also with its weights read from L2
    # and, where they fit, from shared memory, in each slice form that has a
    # plan, and beside fused_neural through the side door); depth 5 and 8 at
    # Z=128 on neural_group's run-time-depth form; rows of 31 members on
    # neural_group_wide, of 64 and 121 on neural_group_w128 (Z=4); fused_neural
    # on what every neural_group route refuses, a row of 122 members.  The
    # Z=128 case without a batch hands every resident frame group of
    # neural_group's plan three frames or more.  Bits identical to the plain
    # version.
    max_err = {name: 0.0 for name in fn.LAUNCHES}
    path_launches = {name: 0 for name in fn.LAUNCHES}
    cases = [("nr_2_0_4", 4, 37, "scalar", 0, False, False, False),
             ("nr_2_0_4", 4, 37, "cell", 2, True, False, False),
             ("nr_2_0_4", 4, 37, "type", 1, True, False, True),
             ("nr_2_0_4", 4, 37, "edge", 2, True, True, True),
             ("nr_2_0_32", 32, 13, "edge", 2, True, True, True),
             ("nr_2_0_32", 32, 13, "type", 0, True, True, False),
             ("nr_2_0_32", 32, 13, "cell", 1, False, True, True),
             ("nr_2_0_32", 32, 13, "edge", 3, True, True, True),
             ("nr_2_0_32", 12, 9, "cell", 3, True, True, True),
             ("nr_2_0_32", 128, 5, "edge", 2, True, True, True),
             ("nr_2_0_32", 128, 5, "scalar", 3, True, False, False),
             ("nr_2_0_32", 128, None, "edge", 2, True, True, True),
             ("nr_2_0_32", 128, 5, "edge", 5, True, True, True),
             ("nr_2_0_32", 128, 5, "edge", 8, True, True, True),
             ("row31", 4, 37, "edge", 2, True, True, True),
             ("row64", 4, 37, "cell", 3, True, True, True),
             ("row121", 4, 37, "edge", 2, True, True, False),
             ("row122", 4, 37, "edge", 2, True, True, True)]
    for code, Z, B, sharing, L, learn_a, learn_o, per_it in cases:
        qc = (wide_row_code(int(code[3:]), Z) if code.startswith("row")
              else qc_layout(get_base_graph(code), Z))
        plan = qc_msg.make_plan(qc)
        T = 5 if L < 5 else L + 2
        model = perturbed_nms(plan, seed=Z + L, num_iterations=T, depth_L=L,
                              weight_sharing=sharing, learnable_alpha=learn_a,
                              learnable_offset=learn_o, per_iteration=per_it)
        dec = fn.make_fused_neural_minsum(qc, model, T, L, per_iteration=per_it)
        assert dec.route == {"row31": "neural_group_wide", "row64": "neural_group_w128",
                             "row121": "neural_group_w128", "row122": "fused_neural"}.get(
                                 code, "neural_group")
        assert dec.run_time_depth == (L > 4)
        grouped = dec.route != "fused_neural"
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        # the wrapper's shared-memory plans and slices are the kernels'
        assert lib.ldpc_neural_smem_bytes(*dims, T, L, dec.frames_per_block, int(dec.shared)) == \
            fn.neural_smem_bytes(qc, T, L, dec.frames_per_block, dec.shared)
        layouts = []  # neural_group's layouts with a plan, the route's first
        if grouped:
            layouts = [s for s in fn.SLICE_LAYOUTS if fn.neural_group_plans(qc, L, slice=s)]
            assert layouts[0] == dec.layout
            glib = fn.kernel_library(dec.word_bits)  # the word's library
            for s in fn.SLICE_LAYOUTS:
                if s:
                    assert 4 * glib.ldpc_neural_group_slice_words(Z, dims[1], dims[3], L, s,
                                                                  dec.word_bits) == \
                        fn.neural_group_scratch_bytes(qc, L, s)
                for staged in (False, True):
                    for p, f in fn.neural_group_plans(qc, L, staged, s):
                        assert glib.ldpc_neural_group_smem_bytes(*dims, L, p, f, int(staged), s,
                                                                 dec.word_bits) \
                            == fn.neural_group_smem_bytes(qc, L, p, f, staged, s)
        if grouped:  # frames in flight
            _, f, _, _, blocks, _ = dec._plan(torch.device("cuda", 0))
            resident = blocks * f * fn.frames_per_group(qc)
        else:
            resident = None if dec.shared else lib.ldpc_neural_occupancy(*dims, T, L, 1, 0) * sms
        if B is None:  # three frames or more for every resident frame group
            B = 3 * resident + 1
        llr = torch.cat([llrs(qc.num_vars, len(range(i, B, 2)), snr, seed=Z + i)
                         for i, snr in enumerate((0.5, 2.0))])
        bits_k = routed_launch(dec, llr, fn.LAUNCHES)
        path_launches[dec.route] += 1
        bits_p = dec.plain(llr)
        others = {}
        if grouped:
            others = {"weights_l2": dec._launch_group(llr, staged=False),
                      "fused_neural": dec._launch_minsum(llr)}
            if fn.neural_group_plans(qc, L, staged=True):
                others["weights_staged"] = dec._launch_group(llr, staged=True)
            for s in layouts[1:] + ([] if dec.layout else [1, 2]):
                others[f"slice_{s}"] = dec._launch_group(llr, slice=s)
        torch.cuda.synchronize()
        same = {name: bool(torch.equal(out, bits_p))
                for name, out in (("route", bits_k), *others.items())}
        max_err[dec.route] = max(max_err[dec.route], (bits_k - bits_p).abs().max().item())
        ok = all(same.values())
        emit({"phase": "nms_compare", "case": f"{code} Z={Z} B={B} T={T} {sharing} L={L} "
              f"alpha={learn_a} offset={learn_o} per_iteration={per_it}", "route": dec.route,
              "layout": dec.layout, "word_bits": dec.word_bits,
              "run_time_depth": dec.run_time_depth,
              "state": "shared" if dec.shared else "global", "frames_per_block":
              dec.frames_per_block, "resident_frames": resident, "bits_identical": same,
              "bit_errors_vs_zero": int(bits_k.sum().item()), "ok": ok})
        if not ok:
            raise AssertionError(f"{dec.route} disagrees with its plain version: {same}")

    # nms_serve_shape: the decoder serve_trained_decoder --model neural_minsum
    # builds (nr_2_0_4 Z=4, T=5, depth 2, edge weights, the committed
    # checkpoint) at its batch of 4096, 0 dB: neural_group (8 frames a group
    # at Z=4) in five rounds beside fused_neural through the side door, both
    # identical to the plain version.
    qc4 = qc_layout(get_base_graph("nr_2_0_4"), 4)
    serve_model = NeuralMinSumDecoder(qc_msg.make_plan(qc4), num_iterations=5, depth_L=2,
                                      weight_sharing="edge", learnable_alpha=True,
                                      loss_mode="mean")
    convert.load_neural_min_sum(Path(__file__).resolve().parent / "results" /
                                "standard_nr_2_0_4.msgpack", serve_model)
    serve_dec = fn.make_fused_neural_minsum(qc4, serve_model, 5, 2)
    llr = llrs(qc4.num_vars, 4096, 0.0, seed=31)
    bits_p = serve_dec.plain(llr)
    same = {"neural_group": bool(torch.equal(routed_launch(serve_dec, llr, fn.LAUNCHES), bits_p)),
            "fused_neural": bool(torch.equal(serve_dec._launch_minsum(llr), bits_p))}
    serve_rounds = [{"neural_group": cuda_ms(lambda: serve_dec(llr), reps=20)[0],
                     "replaced_fused_neural": cuda_ms(lambda: serve_dec._launch_minsum(llr),
                                                      reps=20)[0]} for _ in range(5)]
    serve_median = {k: sorted(r[k] for r in serve_rounds)[2] for k in serve_rounds[0]}
    ok = all(same.values())
    emit({"phase": "nms_serve_shape", "code": "nr_2_0_4", "Z": 4, "iterations": 5, "depth_L": 2,
          "batch": 4096, "route": serve_dec.route, "identical": same, "median_ms": serve_median,
          "rounds_ms": serve_rounds, "frames_per_group": fn.frames_per_group(qc4), "ok": ok})
    if not ok:
        raise AssertionError(f"neural min-sum at the serving shape differs: {same}")

    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    plan32 = qc_msg.make_plan(qc32)
    n = qc32.num_vars

    # nms_unit: unit weights are plain min-sum at alpha 1.  The variable update
    # adds in another order than fused's ((colsum - c2v) + llr against
    # (llr + colsum) - c2v), so decisions may differ on a few bits.
    T_UNIT, B_UNIT = 10, 4096
    unit = NeuralMinSumDecoder(plan32, num_iterations=T_UNIT, depth_L=0, weight_sharing="scalar")
    llr = llrs(n, B_UNIT, 1.0, seed=21)
    unit_dec = fn.make_fused_neural_minsum(qc32, unit, T_UNIT, 0)
    bits_u = routed_launch(unit_dec, llr, fn.LAUNCHES)
    bits_f, _ = fm.make_fused_minsum(qc32, T_UNIT, 1.0, track_convergence=False)(llr)
    differ = int((bits_u != bits_f).sum().item())
    agreement = 1.0 - differ / bits_u.numel()
    ok = agreement >= NMS_UNIT_MIN_AGREEMENT
    emit({"phase": "nms_unit", "batch": B_UNIT, "iterations": T_UNIT, "snr_db": 1.0,
          "route": unit_dec.route, "bits_differing": differ, "bit_agreement": agreement,
          "frame_errors_fused": int((bits_f.sum(dim=1) > 0).sum().item()), "ok": ok})
    if not ok:
        raise AssertionError("unit-weight neural min-sum is not min-sum")

    # nms_main: the trained per-iteration offset min-sum of
    # tools/high_precision_flagship.py at nr_2_0_32 Z=32, -3 dB.
    T, L, B, SNR = 10, 2, 65536, -3.0
    ckpt = "oms10_per_iter_nr_2_0_32.msgpack"
    model = NeuralMinSumDecoder(plan32, num_iterations=T, depth_L=L, weight_sharing="edge",
                                learnable_alpha=True, learnable_offset=True, per_iteration=True,
                                loss_mode="mean")
    convert.load_neural_min_sum(Path(__file__).resolve().parent / "results" / ckpt, model)
    enc = encoder_from_H(expand_base_matrix(get_base_graph("nr_2_0_32"), 32))
    gen = torch.Generator(device="cuda").manual_seed(3)
    tx = enc.random_codewords(gen, B)
    llr = qpsk_awgn_llr(gen, tx, SNR)
    dec = fn.make_fused_neural_minsum(qc32, model, T, L, per_iteration=True)
    assert dec.route == "neural_group"
    bits = routed_launch(dec, llr, fn.LAUNCHES)
    launches = fn.LAUNCHES["neural_group"]
    assert bits.shape == (B, n) and bits.dtype == torch.float32
    ber, fer = (float(x) for x in compute_ber_fer(tx, bits))
    old_bits = dec._launch_minsum(llr)
    plain_ms, bits_p = cuda_ms(lambda: dec.plain(llr), reps=1)
    same = bool(torch.equal(bits, bits_p))
    same_old = bool(torch.equal(old_bits, bits_p))
    max_err["neural_group"] = max(max_err["neural_group"], (bits - bits_p).abs().max().item())
    max_err["fused_neural"] = max(max_err["fused_neural"], (old_bits - bits_p).abs().max().item())
    del bits_p, old_bits
    # Five rounds, the kernel beside the one it replaced (fused_neural through
    # the side door, _launch_minsum) and beside its weights read from L2.
    rounds = []
    for _ in range(5):
        rounds.append({"neural_group": cuda_ms(lambda: dec(llr), reps=5)[0],
                       "replaced_fused_neural": cuda_ms(lambda: dec._launch_minsum(llr),
                                                        reps=3)[0],
                       "weights_l2": cuda_ms(lambda: dec._launch_group(llr, staged=False),
                                             reps=5)[0]})
    median = {k: sorted(r[k] for r in rounds)[2] for k in rounds[0]}
    ms = median["neural_group"]
    bms, bby = nms_bound_ms(qc32, T, L, B)
    # Where the time goes: the same batch through a decoder of depth 1 (the
    # check pass and column pass of one iteration) and through one without
    # residual taps (L=0), each beside the replaced kernel; every split of a
    # frame into parts, weights staged and from L2.  A fixed T: the time
    # depends on the shape, not on the weights.
    variants_ms = {"weights_l2": median["weights_l2"]}
    for name, depth, taps in (("depth_1", 1, L), ("no_taps", T, 0)):
        other = perturbed_nms(plan32, seed=depth + taps, num_iterations=depth, depth_L=taps,
                              weight_sharing="edge", learnable_alpha=True,
                              learnable_offset=True, per_iteration=True)
        vdec = fn.make_fused_neural_minsum(qc32, other, depth, taps, per_iteration=True)
        variants_ms[name] = cuda_ms(lambda: vdec(llr), reps=5)[0]
        variants_ms[f"{name}_replaced"] = cuda_ms(lambda: vdec._launch_minsum(llr), reps=3)[0]
    variants_ms["per_iteration"] = (ms - variants_ms["depth_1"]) / (T - 1)
    variants_ms["parts"] = {
        f"{'staged' if staged else 'weights_l2'} parts={p}":
            cuda_ms(lambda: dec._launch_group(llr, parts=p, staged=staged), reps=3)[0]
        for staged in (True, False)
        for p in sorted({p for p, _ in fn.neural_group_plans(qc32, L, staged) if p <= 16})}
    group_plan = dict(zip(("parts", "frames_per_block", "blocks_per_sm"),
                          fn.neural_group_plan(qc32, L, True)))
    ok = same and same_old and abs(ber / NMS_BER_REF - 1.0) <= NMS_BER_WINDOW
    emit({"phase": "nms_main", "checkpoint": ckpt, "code": "nr_2_0_32", "Z": 32,
          "iterations": T, "depth_L": L, "batch": B, "snr_db": SNR, "route": dec.route,
          "launches": launches, "ms_per_batch": ms,
          "bits_per_s": decode_throughput(B, n, ms / 1e3, name="nms"),
          "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "ber": ber, "fer": fer,
          "ber_reference": NMS_BER_REF, "whole_batch_identical": same,
          "replaced_identical": same_old,
          "speedup_over_replaced": median["replaced_fused_neural"] / ms, "median_ms": median,
          "rounds_ms": rounds, "variants_ms": variants_ms,
          "plan": {**group_plan, "staged_weights": True,
                   "smem_bytes_per_block": fn.neural_group_smem_bytes(
                       qc32, L, group_plan["parts"], group_plan["frames_per_block"], True)},
          "ptxas": group_ptxas(0, 32, False),
          "nvidia_smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"nms main path: identical={same}, replaced identical={same_old}, "
                             f"BER {ber} against {NMS_BER_REF} +- {NMS_BER_WINDOW:.0%}")
    large_rows, replaced = nms_large_phase(smi, max_err)
    entry = {"route": "cuda", "source": "ldpc_tpu_torch/ops/csrc/fused_neural.cu",
             "replaces": "ldpc_tpu/ops/pallas_neural.py:111", "library_ms": None}
    # fused_neural's path: the nms_compare case no neural_group route takes
    # (a row of 122 members); its ms is nms_large's Z=128 shape (its shape
    # before neural_group took it) through the side door.
    return [{"name": "neural_group", "launches": launches, "max_abs_err": max_err["neural_group"],
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, **entry},
            *large_rows,
            {"name": "fused_neural", "launches": path_launches["fused_neural"],
             "max_abs_err": max_err["fused_neural"], **replaced,
             "ms_of": "nms_large Z=128 L=2 through _launch_minsum (side door)", **entry}]


# nms_large: (Z, depth, batch) of nr_2_0_32, T=10, per-iteration edge
# weights, QPSK at -3 dB on random codewords.  Z=128 at depth 2 has
# nms_main's edges a batch; Z=384's batch keeps B * n about equal.
NMS_LARGE = ((128, 2, 16384), (384, 2, 5461), (32, 4, 65536))
NMS_LARGE_T, NMS_LARGE_SNR = 10, -3.0
# Parts of a frame the layout sweep times (each with every frame-group count).
NMS_SWEEP_PARTS = (1, 2, 3, 4, 6, 8, 12, 14, 16, 21, 24, 28, 32)


def nms_large_setup(Z: int, L: int, B: int):
    """(qc, decoder, codewords, LLRs) of an nms_large shape."""
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_neural as fn, qc_msg
    from ldpc_tpu_torch.utils import qpsk_awgn_llr

    bg = get_base_graph("nr_2_0_32")
    qc = qc_layout(bg, Z)
    model = perturbed_nms(qc_msg.make_plan(qc), seed=Z + L, num_iterations=NMS_LARGE_T,
                          depth_L=L, weight_sharing="edge", learnable_alpha=True,
                          learnable_offset=True, per_iteration=True)
    dec = fn.make_fused_neural_minsum(qc, model, NMS_LARGE_T, L, per_iteration=True)
    gen = torch.Generator(device="cuda").manual_seed(Z + L)
    tx = nr_codewords(bg, Z, gen, B)
    return qc, dec, tx, qpsk_awgn_llr(gen, tx, NMS_LARGE_SNR)


def trace_nms_large() -> dict:
    """One neural_group decode of nms_large's Z=128 batch under the profiler."""
    Z, L, B = NMS_LARGE[0]
    _, dec, _, llr = nms_large_setup(Z, L, B)
    dec(llr)  # warm-up: the plan and the first launch
    return {"phase": "trace_nms_large", "Z": Z, "depth_L": L, "batch": B,
            **trace_split(lambda: dec(llr), "nms_large")}


def nms_large_phase(smi: str, max_err: dict) -> tuple[list[dict], dict]:
    """nms_large: each shape's kernels-line row of neural_group, and
    fused_neural's times at Z=128 (its shape before this phase's codes moved
    to neural_group)."""
    from ldpc_tpu_torch.ops import fused_neural as fn
    from ldpc_tpu_torch.utils import compute_ber_fer

    rows, replaced = [], {}
    for Z, L, B in NMS_LARGE:
        qc, dec, tx, llr = nms_large_setup(Z, L, B)
        assert dec.route == "neural_group"
        bits = routed_launch(dec, llr, fn.LAUNCHES)
        launches = fn.LAUNCHES["neural_group"]
        ber, fer = (float(x) for x in compute_ber_fer(tx, bits))
        del tx
        old_bits = dec._launch_minsum(llr)
        plain_ms, bits_p = cuda_ms(lambda: dec.plain(llr), reps=1)
        same = bool(torch.equal(bits, bits_p))
        same_old = bool(torch.equal(old_bits, bits_p))
        err = (bits - bits_p).abs().max().item()
        max_err["neural_group"] = max(max_err["neural_group"], err)
        max_err["fused_neural"] = max(max_err["fused_neural"],
                                      (old_bits - bits_p).abs().max().item())
        del bits_p, old_bits
        rounds = [{"neural_group": cuda_ms(lambda: dec(llr), reps=3)[0],
                   "replaced_fused_neural": cuda_ms(lambda: dec._launch_minsum(llr), reps=1)[0]}
                  for _ in range(5)]
        median = {k: sorted(r[k] for r in rounds)[2] for k in rounds[0]}
        # The sweep: every layout with a plan (staged and from L2 where a
        # whole frame fits), parts of NMS_SWEEP_PARTS, every frame-group count.
        sweep = {}
        for layout in fn.SLICE_LAYOUTS:
            for staged in ((False, True) if layout == 0 else (False,)):
                for p, f in fn.neural_group_plans(qc, L, staged, layout):
                    if p in NMS_SWEEP_PARTS:
                        sweep[f"layout={layout} staged={staged} parts={p} groups={f}"] = cuda_ms(
                            lambda: dec._launch_group(llr, parts=p, staged=staged, slice=layout,
                                                      groups=f), reps=2)[0]
        fastest = min(sweep, key=sweep.get)
        ms = median["neural_group"]
        bms, bby = nms_bound_ms(qc, NMS_LARGE_T, L, B)
        p, f, staged, layout, blocks, _ = dec._plan(llr.device)
        slices = (blocks * f * fn.frames_per_group(qc)
                  * fn.neural_group_scratch_bytes(qc, L, layout) if layout else 0)
        ok = same and same_old
        emit({"phase": "nms_large", "code": "nr_2_0_32", "Z": Z, "iterations": NMS_LARGE_T,
              "depth_L": L, "batch": B, "snr_db": NMS_LARGE_SNR, "route": dec.route,
              "layout": dec.layout, "launches": launches, "ms_per_batch": ms,
              "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "ber": ber, "fer": fer,
              "whole_batch_identical": same, "replaced_identical": same_old,
              "speedup_over_replaced": median["replaced_fused_neural"] / ms,
              "median_ms": median, "rounds_ms": rounds, "sweep_ms": sweep,
              "sweep_fastest": fastest,
              "plan": {"layout": layout, "parts": p, "frames_per_block": f,
                       "blocks_per_sm": blocks // torch.cuda.get_device_properties(0)
                       .multi_processor_count, "staged_weights": staged,
                       "smem_bytes_per_block": fn.neural_group_smem_bytes(qc, L, p, f, staged,
                                                                          layout),
                       "slice_bytes_in_flight": slices},
              "ptxas": group_ptxas(dec.layout, 32, False),
              "nvidia_smi": smi, "ok": ok})
        if not ok:
            raise AssertionError(f"nms_large Z={Z} L={L}: identical={same}, "
                                 f"fused_neural identical={same_old}")
        rows.append({"name": f"neural_group nr_2_0_32 Z={Z} L={L}", "route": "cuda",
                     "source": "ldpc_tpu_torch/ops/csrc/fused_neural.cu",
                     "replaces": "ldpc_tpu/ops/pallas_neural.py:111", "launches": launches,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": bby, "library_ms": None})
        if (Z, L) == NMS_LARGE[0][:2]:
            replaced = {"ms": median["replaced_fused_neural"], "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": bby}
        del llr, dec
    emit({"phase": "trace_nms_large", **trace_in_child("nms_large")})
    return rows, replaced


# nms_wide: the trained min-sum decoders of the codes that only fused_neural
# served before neural_group took rows of 28-121 members and depths past 4.
# (name, code, depth, batch, first SNR): wide_rows' code (rows of 32, Z=64)
# on neural_group_wide and widest_rows' (rows of 64, p = 67) on
# neural_group_w128 at depth 2 and those phases' batches; NR BG2 Z=32 at
# depth 6 on the run-time-depth form at nms_main's batch.  T=10, every
# parameter per iteration (perturbed_nms), QPSK on random codewords; the SNR
# steps by NMS_WIDE_STEP from its first value until the route's BER is at
# most NMS_WIDE_BER (the first SNRs from the plain version on 24-48 frames:
# BER 5e-3 at 6 dB, 3.4e-3 at 7.25 dB, 3.9e-3 at -2.5 dB).
NMS_WIDE = (("wide_rows", "ieee_6x32 Z=64", 2, 65536, 5.5),
            ("widest_rows", "array_4x64_p67", 2, 49152, 6.75),
            ("nr_2_0_32", "nr_2_0_32 Z=32", 6, 65536, -3.0))
NMS_WIDE_T, NMS_WIDE_STEP, NMS_WIDE_BER, NMS_WIDE_STEPS = 10, 0.25, 1e-2, 12


def nms_wide_setup(name: str, L: int):
    """(qc, base graph, decoder) of an nms_wide shape."""
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_neural as fn, qc_msg

    base = {"wide_rows": ieee_shape_base, "widest_rows": array_base,
            "nr_2_0_32": lambda: get_base_graph("nr_2_0_32")}[name]()
    qc = qc_layout(base, {"wide_rows": 64, "widest_rows": 67, "nr_2_0_32": 32}[name])
    model = perturbed_nms(qc_msg.make_plan(qc), seed=qc.Z + L, num_iterations=NMS_WIDE_T,
                          depth_L=L, weight_sharing="edge", learnable_alpha=True,
                          learnable_offset=True, per_iteration=True)
    dec = fn.make_fused_neural_minsum(qc, model, NMS_WIDE_T, L, per_iteration=True)
    return qc, base, dec


def nms_wide_phase(smi: str) -> list[dict]:
    """nms_wide: each shape through its route, launched alone; the whole
    batch identical to the plain version and to fused_neural through the
    side door; five rounds of the route beside fused_neural; a sweep of
    layouts and parts (each with its plan's frame groups); plan, ptxas and
    bound.  Returns the kernels line's three rows."""
    from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix
    from ldpc_tpu_torch.ops import fused_neural as fn
    from ldpc_tpu_torch.utils import compute_ber_fer, qpsk_awgn_llr
    from ldpc_tpu_torch.utils.metrics import decode_throughput

    rows = []
    for name, label, L, B, first_snr in NMS_WIDE:
        qc, base, dec = nms_wide_setup(name, L)
        route = dec.route
        assert route == {"wide_rows": "neural_group_wide", "widest_rows": "neural_group_w128",
                         "nr_2_0_32": "neural_group"}[name] and dec.run_time_depth == (L > 4)
        enc = encoder_from_H(expand_base_matrix(base, qc.Z))
        n = qc.num_vars
        # The SNR: steps until the route's BER is at most NMS_WIDE_BER.
        steps = {}
        for step in range(NMS_WIDE_STEPS):
            snr = first_snr + step * NMS_WIDE_STEP
            gen = torch.Generator(device="cuda").manual_seed(qc.Z + L)
            tx = enc.random_codewords(gen, B)
            llr = qpsk_awgn_llr(gen, tx, snr)
            steps[snr] = float(compute_ber_fer(tx, dec(llr))[0])
            if steps[snr] <= NMS_WIDE_BER:
                break
        if steps[snr] > NMS_WIDE_BER:
            raise AssertionError(f"nms_wide {name}: no SNR gives a BER <= {NMS_WIDE_BER}: {steps}")
        bits = routed_launch(dec, llr, fn.LAUNCHES)
        launches = fn.LAUNCHES[route]
        assert bits.shape == (B, n) and bits.dtype == torch.float32
        assert bool(torch.isfinite(bits).all())
        ber, fer = (float(x) for x in compute_ber_fer(tx, bits))
        del tx
        old_bits = dec._launch_minsum(llr)
        plain_ms, bits_p = cuda_ms(lambda: dec.plain(llr), reps=1)
        same = bool(torch.equal(bits, bits_p))
        same_old = bool(torch.equal(old_bits, bits_p))
        err = max((bits - bits_p).abs().max().item(), (old_bits - bits_p).abs().max().item())
        del bits_p, old_bits
        rounds = [{route: cuda_ms(lambda: dec(llr), reps=3)[0],
                   "replaced_fused_neural": cuda_ms(lambda: dec._launch_minsum(llr), reps=1)[0]}
                  for _ in range(5)]
        median = {k: sorted(r[k] for r in rounds)[2] for k in rounds[0]}
        # The sweep: every layout with a plan (staged and from L2 where a
        # whole frame fits), every parts count with the plan's frame groups.
        sweep = {}
        for layout in fn.SLICE_LAYOUTS:
            for staged in ((False, True) if layout == 0 else (False,)):
                for p in sorted({p for p, _ in fn.neural_group_plans(qc, L, staged, layout)
                                 if p in NMS_SWEEP_PARTS}):
                    sweep[f"layout={layout} staged={staged} parts={p}"] = cuda_ms(
                        lambda: dec._launch_group(llr, parts=p, staged=staged, slice=layout),
                        reps=1)[0]
        ms = median[route]
        bms, bby = nms_bound_ms(qc, NMS_WIDE_T, L, B)
        p, f, staged, layout, blocks, _ = dec._plan(llr.device)
        slices = (blocks * f * fn.frames_per_group(qc)
                  * fn.neural_group_scratch_bytes(qc, L, layout) if layout else 0)
        ok = same and same_old
        emit({"phase": "nms_wide", "shape": name, "code": label, "Z": qc.Z, "n": n,
              "edges": qc.num_edges, "dr_max": qc.dr_max, "iterations": NMS_WIDE_T,
              "depth_L": L, "batch": B, "snr_db": snr, "snr_steps_ber": steps, "route": route,
              "word_bits": dec.word_bits, "run_time_depth": dec.run_time_depth,
              "layout": dec.layout, "launches": launches, "ms_per_batch": ms,
              "bits_per_s": decode_throughput(B, n, ms / 1e3, name="nms_wide"),
              "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "ber": ber, "fer": fer,
              "whole_batch_identical": same, "replaced_identical": same_old,
              "speedup_over_replaced": median["replaced_fused_neural"] / ms,
              "median_ms": median, "rounds_ms": rounds, "sweep_ms": sweep,
              "sweep_fastest": min(sweep, key=sweep.get),
              "plan": {"layout": layout, "parts": p, "frames_per_block": f,
                       "blocks_per_sm": blocks // torch.cuda.get_device_properties(0)
                       .multi_processor_count, "staged_weights": staged,
                       "smem_bytes_per_block": fn.neural_group_smem_bytes(qc, L, p, f, staged,
                                                                          layout),
                       "slice_bytes_in_flight": slices},
              "ptxas": group_ptxas(layout, dec.word_bits, dec.run_time_depth),
              "nvidia_smi": smi, "ok": ok})
        if not ok:
            raise AssertionError(f"nms_wide {name}: identical={same}, "
                                 f"fused_neural identical={same_old}")
        rows.append({"name": route if L <= 4 else f"{route} run-time depth {label} L={L}",
                     "route": "cuda",
                     "source": f"ldpc_tpu_torch/ops/csrc/{fn.GROUP_STEMS[dec.word_bits]}.cu",
                     "replaces": "ldpc_tpu/ops/pallas_neural.py:111", "launches": launches,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": bby, "library_ms": None,
                     "replaced_fused_neural_ms": median["replaced_fused_neural"]})
        del llr, dec
    return rows


# ---------------------------------------------------------------------------
# The fully-neural message GNN path
# ---------------------------------------------------------------------------

MSG_SOFT_ATOL = 3e-2  # the JAX package's bar (tests/test_pallas_gnn.py)
MSG_CONFIDENT = 0.05  # decisions held where the plain version has |p - 0.5| > this
MSG_MIN_BIT_AGREEMENT = 0.999
MSG_MIN_MIXED = 1e-3  # least share of each decision among confident bits, where held
# The TPU kernel each fully-neural kernel replaces (ldpc_tpu/ops/pallas_gnn.py), B6..B9.
MSG_TPU_LINE = {"msg_gnn": "137", "msg_gnn_v2": "295", "msg_gnn_v3": "644", "msg_gnn_v4": "952"}


def msg_bound_ms(qc, h: int, T: int, inject: bool, kind: str, B: int) -> tuple[float, str]:
    """Least time for a batch of the fully-neural decode, derived in the
    header of ldpc_tpu_torch/ops/csrc/fused_msg_gnn_tc.cu: the (h, h) products
    at the dense bf16 tensor-core rate, elementwise work at the float32 rate
    (the two run beside each other), LLRs read and soft bits written once.
    Each kernel does its own products: B8 projects every message by W1ca
    instead of every check mean, B9's last layer has no second product."""
    E, n, M = qc.num_edges, qc.num_vars, qc.num_base_rows * qc.Z
    inj = int(inject)
    mat = 2 * h * h
    if kind in ("msg_gnn", "msg_gnn_v2"):
        products = T * (4 * E + n + M + 2 * inj * n) * mat
        per_layer = (2 * E + n + M) * h + (6 + 2 * inj) * h * E \
            + (3 if kind == "msg_gnn" else 1) * h * E + (inj * n * h if kind == "msg_gnn" else 0)
        elementwise = (T * per_layer + (T - 1) * h * E + 2 * E * h + 2 * inj * n * h
                       + 2 * E * h + 2 * E + 4 * n)
    else:
        # per layer: means (E adds, n or M multiplies), the b1v, b1c and LLR
        # adds of the shared terms; per message: two adds and two ReLUs (+1
        # with injection), b2, the delta of te, the residual from layer 1 on;
        # once: seed 3 E h (+2 n h with injection)
        shared = (2 * E + 2 * n + 2 * M + inj * n) * h
        seed = 3 * E * h + 2 * inj * n * h
        if kind == "msg_gnn_v3":
            products = T * (5 * E + n + 2 * inj * n) * mat
            elementwise = (T * (shared + (6 + inj) * h * E) + (T - 1) * h * E + seed
                           + 2 * E * h + 2 * E + 4 * n)
        else:  # msg_gnn_v4: T - 1 full layers and a thin last one
            products = ((T - 1) * (4 * E + n + M + 2 * inj * n) + (2 * E + n + M + 2 * inj * n)) \
                * mat + E * 2 * (2 * h + (h if T > 1 else 0))
            elementwise = (T * shared + (T - 1) * (6 + inj) * h * E + max(T - 2, 0) * h * E
                           + (4 + inj) * h * E + (E if T > 1 else 0) + seed + 2 * E + 4 * n)
    t_ops = max(B * products / PEAK_BF16_TENSOR_OPS, B * elementwise / PEAK_F32_OPS) * 1e3
    t_bytes = B * n * 8 / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def perturbed_msg_model(plan, T: int, h: int, inject: bool, share: bool, seed: int,
                        scale: float = 0.02):
    """A fully-neural decoder initialised from a seed, every parameter moved
    by scale * normal noise: the zero-init output projection would make the
    untrained outputs independent of the GNN."""
    from ldpc_tpu_torch.models import create_message_gnn_decoder

    gen = torch.Generator().manual_seed(seed)
    model = create_message_gnn_decoder(plan, num_iterations=T, hidden_dim=h,
                                       input_injection=inject, share_layers=share, generator=gen)
    return add_noise(model, scale, gen)


def msg_compare(soft_k: torch.Tensor, soft_p: torch.Tensor, label: str, phase: str,
                atol: float | None = MSG_SOFT_ATOL, min_agreement: float | None = None,
                mixed: bool = False) -> float:
    """Kernel against plain version: soft bits within ``atol`` and decisions
    identical where the plain version is confident; or, with
    ``min_agreement``, decisions equal on that share of all bits.  With
    ``mixed``, the plain version's confident decisions must hold both values
    (a run that decides every bit alike cannot tell a kernel from a
    constant).  Returns the largest soft difference."""
    torch.cuda.synchronize()
    assert soft_k.shape == soft_p.shape and soft_k.dtype == torch.float32, label
    assert bool(torch.isfinite(soft_k).all()) and float(soft_k.min()) >= 0.0 \
        and float(soft_k.max()) <= 1.0, label
    err = (soft_k - soft_p).abs().max().item()
    same = (soft_k > 0.5) == (soft_p > 0.5)
    confident = (soft_p - 0.5).abs() > MSG_CONFIDENT
    agreement = same.float().mean().item()
    confident_same = bool(same[confident].all())
    ones = (soft_p[confident] > 0.5).float().mean().item()
    if min_agreement is None:
        ok = (atol is None or err <= atol) and confident_same
    else:
        ok = agreement >= min_agreement
    if mixed:
        ok = ok and MSG_MIN_MIXED <= ones <= 1.0 - MSG_MIN_MIXED
    emit({"phase": phase, "case": label, "frames": soft_k.shape[0], "max_abs_err": err,
          "bit_agreement": agreement, "confident_share": confident.float().mean().item(),
          "confident_ones_share": ones, "confident_decisions_identical": confident_same,
          "ok": ok})
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {label}")
    return err


# The tensor-core kernels: (source stem, kernel template name).
TC_KERNELS = {"msg_gnn": ("fused_msg_gnn_tc", "msg_gnn_tc_kernel"),
              "msg_gnn_v2": ("fused_msg_gnn_tc", "msg_gnn_v2_tc_kernel"),
              "msg_gnn_v3": ("fused_msg_gnn_tc", "msg_gnn_v3_tc_kernel"),
              "msg_gnn_v4": ("fused_msg_gnn_tc", "msg_gnn_v4_tc_kernel"),
              "corrected_v2": ("fused_gnn_tc", "corrected_v2_tc_kernel"),
              "corrected": ("fused_gnn_tc", "corrected_tc_kernel")}


def tc_shape(qc, h: int, inject: bool, kind: str = "msg_gnn_v2") -> dict:
    """A tensor-core kernel's block shape from its occupancy plan, and the
    registers a thread and spill bytes of its instantiation from the
    compiler's report (at h=128: msg_gnn_wide_tc_kernel's)."""
    import re

    from ldpc_tpu_torch.ops import _build, fused_gnn as fg

    if kind in ("corrected_v2", "corrected"):
        warps, blocks = fg.corrected_tc_plan(qc, h, inject, kind)
    else:
        warps, blocks = fg.msg_gnn_tc_plan(qc, h, inject, kind)
    stem, kernel = TC_KERNELS[kind]
    log = _build.build_log(stem)
    props = log[log.index("Function properties for _ZN"):]
    name = (f"msg_gnn_wide_tc_kernelILb{int(inject)}ELi{WIDE_KINDS[kind]}E" if h == 128
            else f"{kernel}ILi{h}ELb{int(inject)}E")
    report = props[props.index(name):].split("Compile time")[0]
    return {"warps_per_block": warps, "blocks_per_sm": blocks, "warps_per_sm": warps * blocks,
            "registers_per_thread": int(re.search(r"Used (\d+) registers", report).group(1)),
            "spill_store_bytes": int(re.search(r"(\d+) bytes spill stores", report).group(1))}


MSG_MAIN = dict(H=64, T=20, B=2048, SNR=3.0, model_seed=11, llr_seed=12)


def msg_builders() -> dict:
    """The four fully-neural builders by kernel name, msg_gnn_v2 (the one
    bench.py serves) first."""
    from ldpc_tpu_torch.ops import fused_gnn as fg

    return {"msg_gnn_v2": fg.make_fused_gnn_decoder_v2, "msg_gnn": fg.make_fused_gnn_decoder,
            "msg_gnn_v3": fg.make_fused_gnn_decoder_v3, "msg_gnn_v4": fg.make_fused_gnn_decoder_v4}


def trace_msg_gnn(kind: str) -> dict:
    """One decode of the msg_gnn_main batch by one fully-neural kernel under
    the profiler."""
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_gnn as fg, qc_msg

    m = MSG_MAIN
    qc = qc_layout(get_base_graph("nr_2_0_32"), 32)
    model = perturbed_msg_model(qc_msg.make_plan(qc), m["T"], m["H"], False, False,
                                seed=m["model_seed"])
    llr = llrs(qc.num_vars, m["B"], m["SNR"], seed=m["llr_seed"])
    dec = msg_builders()[kind](qc, model, m["T"], m["H"])
    dec(llr)  # warm-up: the plan and the first launch
    return {"phase": "trace_msg_gnn", "kernel": kind, "batch": m["B"],
            **trace_split(lambda: dec(llr), kind)}


TRACE_ATTEMPTS = 3


def trace_in_child(name: str) -> dict:
    """trace_z384, trace_layered, trace_sumproduct, trace_gnn, trace_nms_large,
    trace_train or trace_msg_gnn
    (``name`` a fully-neural kernel's) in a process of its own: a second
    torch.profiler session in one process (after trace_main) recorded no
    kernel on the card.  The child loads the libraries this process built.

    A fresh process's profiler now and then records no activity on the card
    at all (not even the warm-up's ``aten::fill_``), so a child whose trace
    holds no device time is run again, up to TRACE_ATTEMPTS children in all;
    each such child's standard error goes to ours, and the result says how
    many children it took.  It fails if none recorded device time."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--trace", name],
                              capture_output=True, text=True, timeout=600, check=True)
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        if result["device_ms"] > 0:
            return {**result, "attempts": attempt}
        print(f"chip_smoke: trace_{name} attempt {attempt} recorded no device time: {result}\n"
              f"its standard error, last 4000 characters:\n{proc.stderr[-4000:]}",
              file=sys.stderr, flush=True)
    raise AssertionError(f"trace_{name} recorded no device time in {TRACE_ATTEMPTS} processes")


def msg_gnn_phases(smi: str) -> list[dict]:
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_gnn as fg, qc_msg
    from ldpc_tpu_torch.ops.msg_gnn_exact import (EXACT_CASES, EXACT_TE_CASES,
                                                  EXACT_TYPE_EMBEDDINGS, exact_msg_gnn_case)
    from ldpc_tpu_torch.utils.metrics import decode_throughput

    tc_lib = fg.tc_kernel_library()
    builders = msg_builders()
    max_err = {kind: 0.0 for kind in builders}

    # msg_gnn_compare: T=2, h 16 and 64, injection and share_layers.
    for code, Z, h, B in (("toy_4x8", 4, 16, 37), ("nr_2_0_4", 4, 64, 21),
                          ("nr_2_0_32", 32, 64, 13)):
        qc = qc_layout(get_base_graph(code), Z)
        plan = qc_msg.make_plan(qc)
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        llr = torch.cat([llrs(qc.num_vars, len(range(i, B, 3)), snr, seed=Z + h + i)
                         for i, snr in enumerate((0.0, 2.0, 4.0))])
        for inject, share in ((False, False), (True, False), (True, True)):
            model = perturbed_msg_model(plan, 2, h, inject, share, seed=7)
            for kind, build in builders.items():
                # the wrapper's shared-memory and scratch plans are the kernel's
                entry = fg.TC_ENTRY[kind]
                warps = fg.msg_gnn_tc_plan(qc, h, inject, kind)[0]
                for w in (1, warps):
                    assert getattr(tc_lib, f"{entry}_tc_smem_bytes")(h, int(inject), *dims, w) \
                        == fg.msg_gnn_smem_bytes(qc, h, kind, inject, w)
                assert getattr(tc_lib, f"{entry}_tc_scratch_floats")(h, *dims) == \
                    fg.msg_gnn_scratch_floats(qc, h, kind)
                dec = build(qc, model, 2, h, share_layers=share, input_injection=inject)
                label = f"{kind} {code} Z={Z} h={h} B={B} T=2 inject={inject} share={share}"
                err = msg_compare(dec(llr), dec.plain(llr), label, "msg_gnn_compare")
                max_err[kind] = max(max_err[kind], err)

    # Exact inputs (ops/msg_gnn_exact.py): every sum the tensor-core kernels
    # reorder is exact in any order, so each must equal its plain version bit
    # for bit; msg_gnn_v3 and msg_gnn_v4 also with nonzero type embeddings
    # (their delta tables), msg_gnn_v4 also at T=1 (its thin last layer alone).
    exact = [(kind, *case, 2, (0.0,)) for kind in builders for case in EXACT_CASES]
    exact += [(kind, *case, EXACT_TYPE_EMBEDDINGS) for kind in ("msg_gnn_v3", "msg_gnn_v4")
              for case in EXACT_TE_CASES]
    exact += [("msg_gnn_v4", *case, 1, (0.0,)) for case in EXACT_CASES]
    for kind, code, Z, h, B, inject, share, T, te in exact:
        qc = qc_layout(get_base_graph(code), Z)
        model, llr_np = exact_msg_gnn_case(qc, h, B, inject, share, num_iterations=T,
                                           type_embeddings=te)
        dec = builders[kind](qc, model, T, h, share_layers=share, input_injection=inject)
        llr = torch.from_numpy(llr_np).cuda()
        soft_k, soft_p = dec(llr), dec.plain(llr)
        torch.cuda.synchronize()
        ok = bool(torch.equal(soft_k, soft_p))
        label = (f"{kind} exact {code} Z={Z} h={h} B={B} T={T} inject={inject} share={share} "
                 f"type_embeddings={te}")
        emit({"phase": "msg_gnn_compare", "case": label, "identical": ok,
              "max_abs_err": (soft_k - soft_p).abs().max().item(),
              "ones_share": (soft_p > 0.5).float().mean().item(), "ok": ok})
        if not ok:
            raise AssertionError(f"differs from its plain version on exact inputs: {label}")

    # The noise floor at nr_2_0_32 Z=32 h=64: one T=3 model decoded to depth
    # 1, 2 and 3, the kernel against the plain version beside the plain version
    # on the card against itself on the CPU.  Printed; decisions held where
    # the plain version is confident.
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    plan32 = qc_msg.make_plan(qc32)
    n = qc32.num_vars
    llr = llrs(n, 3, 2.0, seed=32)
    model = perturbed_msg_model(plan32, 3, 64, True, False, seed=7)
    for kind, build in builders.items():
        by_depth = []
        for depth in (1, 2, 3):
            dec = build(qc32, model, depth, 64, input_injection=True)
            soft_k, soft_p = dec(llr), dec.plain(llr)
            soft_cpu = build(qc32, model, depth, 64, input_injection=True, device="cpu")(llr.cpu())
            by_depth.append({"iterations": depth,
                             "max_abs_err": (soft_k - soft_p).abs().max().item(),
                             "plain_card_vs_plain_cpu":
                                 (soft_p - soft_cpu.to(llr.device)).abs().max().item()})
            msg_compare(soft_k, soft_p, f"noise floor {kind} depth {depth}", "msg_gnn_compare",
                        atol=None)
        emit({"phase": "msg_gnn_compare", "case": f"noise floor {kind} nr_2_0_32 h=64",
              "by_depth": by_depth, "ok": True})

    # msg_gnn_main: bench.py section_msg_gnn at full width.
    H, T, B, SNR = MSG_MAIN["H"], MSG_MAIN["T"], MSG_MAIN["B"], MSG_MAIN["SNR"]
    llr = llrs(n, B, SNR, seed=MSG_MAIN["llr_seed"])
    # The random T=20 model decides every bit 1, so its run cannot tell a
    # kernel from a constant.  First the whole batch through a T=2 model of
    # the same width, which does not saturate: every resident block decodes
    # many frames, each held within the soft bar with confident decisions
    # identical, and both decisions present.
    t2_model = perturbed_msg_model(plan32, 2, H, False, False, seed=11)
    for kind, build in builders.items():
        dec = build(qc32, t2_model, 2, H)
        err = msg_compare(dec(llr), dec.plain(llr), f"{kind} T=2 whole batch of {B}",
                          "msg_gnn_main", mixed=True)
        max_err[kind] = max(max_err[kind], err)
    model = perturbed_msg_model(plan32, T, H, False, False, seed=MSG_MAIN["model_seed"])
    entries = {}
    for kind, build in builders.items():
        dec = build(qc32, model, T, H)
        for key in fg.LAUNCHES:
            fg.LAUNCHES[key] = 0
        soft = dec(llr)
        torch.cuda.synchronize()
        launches = dict(fg.LAUNCHES)
        if launches[kind] != 1:
            raise AssertionError(f"msg_gnn main path did not run the {kind} kernel: {launches}")
        # five rounds and a profiler trace
        rounds_ms = [cuda_ms(lambda: dec(llr), reps=2)[0] for _ in range(5)]
        ms = sorted(rounds_ms)[2]
        emit(trace_in_child(kind))
        plain_ms, soft_p = cuda_ms(lambda: dec.plain(llr), reps=1)
        err = msg_compare(soft, soft_p, f"{kind} main path T={T} whole batch", "msg_gnn_main",
                          min_agreement=MSG_MIN_BIT_AGREEMENT)
        del soft_p
        bms, bby = msg_bound_ms(qc32, H, T, False, kind, B)
        # Where the time goes: a decoder of depth 1 (seed, one layer, output).
        shallow = build(qc32, model, 1, H)
        depth_1 = cuda_ms(lambda: shallow(llr), reps=3)[0]
        hard = (soft > 0.5).float()  # all-zero codewords: decisions of 1 are errors
        emit({"phase": "msg_gnn_main", "kernel": kind, "code": "nr_2_0_32", "Z": 32,
              "hidden_dim": H, "iterations": T, "batch": B, "snr_db": SNR,
              "launches": launches, "ms_per_batch": ms,
              "bits_per_s": decode_throughput(B, n, ms / 1e3, name=kind), "plain_ms": plain_ms,
              "bound_ms": bms, "bound_by": bby, "max_abs_err": err,
              "variants_ms": {"depth_1": depth_1, "per_layer": (ms - depth_1) / (T - 1)},
              "rounds_ms": rounds_ms,
              "ber_zero_codeword": hard.mean().item(),
              "fer_zero_codeword": (hard.sum(dim=1) > 0).float().mean().item(),
              "blocks_per_sm": fg.msg_gnn_tc_plan(qc32, H, False, kind)[1],
              **tc_shape(qc32, H, False, kind),
              "nvidia_smi": smi})
        entries[kind] = {
            "name": kind, "route": "cuda", "source": "ldpc_tpu_torch/ops/csrc/fused_msg_gnn_tc.cu",
            "replaces": "ldpc_tpu/ops/pallas_gnn.py:" + MSG_TPU_LINE[kind],
            "launches": launches[kind], "max_abs_err": max(max_err[kind], err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None}
    return [entries[kind] for kind in MSG_TPU_LINE]


# ---------------------------------------------------------------------------
# B7 and B9 at h=128: the weights streamed in chunks
# ---------------------------------------------------------------------------

WIDE_KINDS = {"msg_gnn_v2": 7, "msg_gnn_v4": 9}  # the kernels built at h=128, and their V
# The JAX record the ported ft-floor path is held against, at 1 dB; each
# checkpoint gets at least 2.5e5 frames (62 batches of 4096).
FLOOR_RECORD = "gnn_h128t10_ft_floor.json"
FLOOR = dict(snr=1.0, trials=62, batch=4096)
FLOOR_SIGMAS = 3.0
WIDE_MAIN = dict(MSG_MAIN, H=128)


def once_ms(fn):
    """(device time of one call of fn, its result): for the plain versions,
    whose one call takes seconds."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def rate_sigma(rate: float, fer: float, frames: int) -> float:
    """Binomial standard error of a BER or FER estimate counted on frame
    errors: the rate times the relative error of the frame-error count
    (bit errors come in frames, so bits are no independent trials)."""
    return rate * ((1.0 - fer) / (fer * frames)) ** 0.5 if fer > 0 else 0.0


def msg_gnn_wide_phases(smi: str) -> list[dict]:
    """B7 and B9 at h=128: against their plain versions, exact inputs, the
    ported ft-floor path on the h=128 T=10 checkpoints, and their times."""
    import tempfile

    from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix, get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_gnn as fg, qc_msg
    from ldpc_tpu_torch.ops.msg_gnn_exact import EXACT_WIDE_CASES, exact_msg_gnn_case
    from ldpc_tpu_torch.tools import eval_ft_floor
    from ldpc_tpu_torch.utils import qpsk_awgn_llr

    tc_lib = fg.tc_kernel_library()
    builders = {kind: msg_builders()[kind] for kind in WIDE_KINDS}
    max_err = {kind: 0.0 for kind in WIDE_KINDS}
    H = 128

    # Compare: T=2 at nr_2_0_4 Z=4 and nr_2_0_32 Z=32, injection and share_layers.
    for code, Z, B in (("nr_2_0_4", 4, 21), ("nr_2_0_32", 32, 7)):
        qc = qc_layout(get_base_graph(code), Z)
        plan = qc_msg.make_plan(qc)
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        llr = torch.cat([llrs(qc.num_vars, len(range(i, B, 3)), snr, seed=Z + H + i)
                         for i, snr in enumerate((0.0, 2.0, 4.0))])
        for inject, share in ((False, False), (True, False), (True, True)):
            model = perturbed_msg_model(plan, 2, H, inject, share, seed=7)
            for kind, build in builders.items():
                entry = fg.TC_ENTRY[kind]
                warps = fg.msg_gnn_tc_plan(qc, H, inject, kind)[0]
                for w in (1, warps):
                    assert getattr(tc_lib, f"{entry}_tc_smem_bytes")(H, int(inject), *dims, w) \
                        == fg.msg_gnn_smem_bytes(qc, H, kind, inject, w)
                assert getattr(tc_lib, f"{entry}_tc_scratch_floats")(H, *dims) == \
                    fg.msg_gnn_scratch_floats(qc, H, kind)
                dec = build(qc, model, 2, H, share_layers=share, input_injection=inject)
                label = f"{kind} {code} Z={Z} h={H} B={B} T=2 inject={inject} share={share}"
                err = msg_compare(dec(llr), dec.plain(llr), label, "msg_gnn_wide")
                max_err[kind] = max(max_err[kind], err)

    # Exact inputs at h=128 (EXACT_WIDE_CASES): identical; B9 also at T=1.
    exact = [(kind, *case, 2) for kind in WIDE_KINDS for case in EXACT_WIDE_CASES]
    exact += [("msg_gnn_v4", *case, 1) for case in EXACT_WIDE_CASES]
    for kind, code, Z, h, B, inject, share, T in exact:
        qc = qc_layout(get_base_graph(code), Z)
        model, llr_np = exact_msg_gnn_case(qc, h, B, inject, share, num_iterations=T)
        dec = builders[kind](qc, model, T, h, share_layers=share, input_injection=inject)
        llr = torch.from_numpy(llr_np).cuda()
        soft_k, soft_p = dec(llr), dec.plain(llr)
        torch.cuda.synchronize()
        ok = bool(torch.equal(soft_k, soft_p))
        label = f"{kind} exact {code} Z={Z} h={h} B={B} T={T} inject={inject} share={share}"
        emit({"phase": "msg_gnn_wide", "case": label, "identical": ok,
              "max_abs_err": (soft_k - soft_p).abs().max().item(),
              "ones_share": (soft_p > 0.5).float().mean().item(), "ok": ok})
        if not ok:
            raise AssertionError(f"differs from its plain version on exact inputs: {label}")

    # The path: the ported tools/eval_ft_floor.py at 1 dB on both h=128 T=10
    # checkpoints, held against the JAX record: through B7 as the JAX tool
    # serves them, and through B9 by the tool's loop on the same seeds.
    record = json.loads((Path(__file__).resolve().parent / "results" / FLOOR_RECORD).read_text())
    j = record["snr_range"].index(FLOOR["snr"])
    ref_frames = record["protocol"]["trials"] * record["protocol"]["batch"]
    path_launches = {}
    for kind in WIDE_KINDS:
        for key in fg.LAUNCHES:
            fg.LAUNCHES[key] = 0
        if kind == "msg_gnn_v2":
            with tempfile.TemporaryDirectory() as tmp:
                floor = eval_ft_floor.main(
                    ["--snrs", str(FLOOR["snr"]), "--trials", str(FLOOR["trials"]),
                     "--batch", str(FLOOR["batch"]), "--out", str(Path(tmp) / "floor.json")])
            got_models, protocol = floor["models"], floor["protocol"]
        else:
            got_models = eval_ft_floor.error_counts(
                builders[kind], [FLOOR["snr"]], FLOOR["trials"], FLOOR["batch"],
                eval_ft_floor.SEED, torch.device("cuda"))
            protocol = {"serving": f"eval_ft_floor.error_counts through {kind}"}
        torch.cuda.synchronize()
        path_launches[kind] = dict(fg.LAUNCHES)
        checks = {}
        for tag, ref in record["models"].items():
            got = got_models[tag]
            frames = got["frames"]
            fer, ber = got["fer"][0], got["ber"][0]
            fer_ref, ber_ref = ref["fer"][j], ref["ber"][j]
            sig_fer = (rate_sigma(fer, fer, frames) ** 2
                       + rate_sigma(fer_ref, fer_ref, ref_frames) ** 2) ** 0.5
            sig_ber = (rate_sigma(ber, fer, frames) ** 2
                       + rate_sigma(ber_ref, fer_ref, ref_frames) ** 2) ** 0.5
            checks[tag] = {"frames": frames, "frame_errors": got["frame_errors"][0],
                           "bit_errors": got["bit_errors"][0], "fer": fer, "ber": ber,
                           "fer_ref": fer_ref, "ber_ref": ber_ref, "ref_frames": ref_frames,
                           "fer_sigmas": abs(fer - fer_ref) / sig_fer,
                           "ber_sigmas": abs(ber - ber_ref) / sig_ber, "seconds": got["seconds"]}
        ok = (path_launches[kind][kind] == FLOOR["trials"] * len(checks) and all(
            c["frames"] >= 2.5e5 and c["fer_sigmas"] <= FLOOR_SIGMAS
            and c["ber_sigmas"] <= FLOOR_SIGMAS for c in checks.values()))
        emit({"phase": "msg_gnn_wide", "case": f"ft-floor path (eval_ft_floor) at 1 dB, {kind}",
              "launches": path_launches[kind], "models": checks, "bar_sigmas": FLOOR_SIGMAS,
              "protocol": protocol, "ok": ok})
        if not ok:
            raise AssertionError(f"the h=128 ft-floor path through {kind} disagrees with "
                                 f"{FLOOR_RECORD}: {checks}")

    # The kernel against the module's forward on one batch of each checkpoint.
    qc4 = qc_layout(get_base_graph("nr_2_0_4"), 4)
    plan4 = qc_msg.make_plan(qc4)
    enc = encoder_from_H(expand_base_matrix(get_base_graph("nr_2_0_4"), 4))
    gen = torch.Generator(device="cuda").manual_seed(21)
    bits = enc.random_codewords(gen, FLOOR["batch"])
    llr4 = qpsk_awgn_llr(gen, bits, FLOOR["snr"])
    models = {}
    for tag, name in eval_ft_floor.MODELS[:2]:
        model = eval_ft_floor.load_model(eval_ft_floor.RESULTS / name, plan4)
        models[tag] = model
        with torch.no_grad():
            soft_m = model(llr4, plan4)[0]
        confident = (soft_m - 0.5).abs() > MSG_CONFIDENT
        for kind, build in builders.items():
            soft_k = build(qc4, model, 10, H, input_injection=True)(llr4)
            same = ((soft_k > 0.5) == (soft_m > 0.5))[confident].float().mean().item()
            ok = same >= MSG_MIN_BIT_AGREEMENT
            emit({"phase": "msg_gnn_wide", "case": f"{kind} against the module, {tag}",
                  "frames": FLOOR["batch"], "confident_share": confident.float().mean().item(),
                  "confident_agreement": same,
                  "max_abs_diff": (soft_k - soft_m).abs().max().item(), "ok": ok})
            if not ok:
                raise AssertionError(f"{kind} disagrees with the module on {tag}: {same}")

    # Times: the path's shape (the ft checkpoint) and msg_gnn_main's shape.
    mma = sass_mma_counts("fused_msg_gnn_tc")
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    m = WIDE_MAIN
    llr32 = llrs(qc32.num_vars, m["B"], m["SNR"], seed=m["llr_seed"])
    model32 = perturbed_msg_model(qc_msg.make_plan(qc32), m["T"], H, False, False,
                                  seed=m["model_seed"])
    shapes = {"path": ("nr_2_0_4", qc4, models["h=128 T=10 ft"], 10, True, llr4),
              "main": ("nr_2_0_32", qc32, model32, m["T"], False, llr32)}
    entries = {}
    for kind, build in builders.items():
        timed = {}
        for shape, (code, qc, model, T, inject, llr) in shapes.items():
            dec = build(qc, model, T, H, input_injection=inject)
            for key in fg.LAUNCHES:
                fg.LAUNCHES[key] = 0
            soft = dec(llr)
            torch.cuda.synchronize()
            launches = dict(fg.LAUNCHES)
            if launches[kind] != 1:
                raise AssertionError(f"{shape} did not run the {kind} kernel once: {launches}")
            rounds_ms = [cuda_ms(lambda: dec(llr), reps=2)[0] for _ in range(5)]
            plain_ms, soft_p = once_ms(lambda: dec.plain(llr))
            err = msg_compare(soft, soft_p, f"{kind} h={H} {shape} shape T={T} whole batch",
                              "msg_gnn_wide", min_agreement=MSG_MIN_BIT_AGREEMENT)
            del soft_p
            bms, bby = msg_bound_ms(qc, H, T, inject, kind, llr.shape[0])
            V = WIDE_KINDS[kind]
            # On wgmma; mma.sync (HMMA) only in B9's thin last-layer products.
            ops = [c for k, c in mma.items()
                   if f"msg_gnn_wide_tc_kernelILb{int(inject)}ELi{V}E" in k]
            if len(ops) != 1 or ops[0]["HGMMA"] < 1 or (ops[0]["HMMA"] > 0) != (V == 9):
                raise AssertionError(f"{kind} at h={H} is not on wgmma as built: {ops}")
            timed[shape] = {"code": code, "Z": qc.Z, "iterations": T, "inject": inject,
                            "batch": llr.shape[0], "launches": launches, "rounds_ms": rounds_ms,
                            "ms": sorted(rounds_ms)[2], "plain_ms": plain_ms, "bound_ms": bms,
                            "bound_by": bby, "max_abs_err": err, "mma": ops[0],
                            **tc_shape(qc, H, inject, kind)}
        emit({"phase": "msg_gnn_wide", "kernel": kind, "hidden_dim": H, "times": timed,
              "nvidia_smi": smi})
        path = timed["path"]
        entries[kind] = {
            "name": f"{kind}_h128", "route": "cuda",
            "source": "ldpc_tpu_torch/ops/csrc/fused_msg_gnn_tc.cu",
            "replaces": "ldpc_tpu/ops/pallas_gnn.py:" + MSG_TPU_LINE[kind],
            "launches": path_launches[kind][kind],
            "launches_of": f"the ft-floor path through {kind} (eval_ft_floor)",
            "max_abs_err": max(max_err[kind], path["max_abs_err"], timed["main"]["max_abs_err"]),
            "ms": path["ms"], "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"],
            "bound_by": path["bound_by"], "library_ms": None,
            "ms_of": "nr_2_0_4 Z=4, T=10, injection, batch 4096 (the ft-floor path's shape)",
            "variants_ms": {"msg_gnn_main_shape_h128": timed["main"]["ms"]},
            "variants_plain_ms": {"msg_gnn_main_shape_h128": timed["main"]["plain_ms"]},
            "variants_bound_ms": {"msg_gnn_main_shape_h128": timed["main"]["bound_ms"]}}
    return [entries[kind] for kind in WIDE_KINDS]


# Printed beside the serving entry point's numbers, not held: that file's
# protocol may differ (results/nr_2_0_4_comparison.json at 0 dB).
SERVE_REFERENCE = {"message_gnn": ("Message GNN (trained)", 0.0498, 0.959),
                   "neural_minsum": ("Neural min-sum 5it (trained)", 1.91e-3, 0.0727)}


def serve_phase() -> None:
    """The serving entry point on the committed nr_2_0_4 checkpoints, with
    its defaults (batch 4096, 0 dB, random codewords)."""
    from ldpc_tpu_torch import serve_trained_decoder
    from ldpc_tpu_torch.ops import fused_gnn as fg, fused_neural as fn

    results = Path(__file__).resolve().parent / "results"
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout

    # The route make_fused_neural_minsum takes for the entry point's decoder
    # (nr_2_0_4 Z=4, depth 2).
    nms_route = ("neural_group" if fn.neural_group_fits(qc_layout(get_base_graph("nr_2_0_4"), 4), 2)
                 else "fused_neural")
    for model, ckpt, counters, kind in (
            ("message_gnn", "message_gnn_nr_2_0_4.msgpack", fg.LAUNCHES, "msg_gnn"),
            ("neural_minsum", "standard_nr_2_0_4.msgpack", fn.LAUNCHES, nms_route)):
        for key in counters:
            counters[key] = 0
        out = serve_trained_decoder.main(["--model", model, "--checkpoint",
                                          str(results / ckpt)])
        torch.cuda.synchronize()
        name, ber_ref, fer_ref = SERVE_REFERENCE[model]
        ok = counters[kind] >= 1 and out["device"] == "cuda"
        emit({"phase": "serve", "checkpoint": ckpt, "kernel": kind, "launches": dict(counters),
              **out,
              "reference": {"name": name, "ber": ber_ref, "fer": fer_ref}, "ok": ok})
        if not ok:
            raise AssertionError(f"serve_trained_decoder --model {model} did not run its kernel")


BENCH_MIN_AGREEMENT = 0.999  # each fused variant against the module's confident decisions


def bench_phase(smi: str) -> None:
    """The GNN kernel bench at its defaults (nr_2_0_4 Z=4, h=64, T=5,
    injection, batch 2048) on the committed nr_2_0_4 checkpoints: each of
    the six fused variants against the module's forward on the card."""
    from ldpc_tpu_torch.ops import fused_gnn as fg
    from ldpc_tpu_torch.tools import bench_gnn_kernel

    results = Path(__file__).resolve().parent / "results"
    for key in fg.LAUNCHES:
        fg.LAUNCHES[key] = 0
    out = bench_gnn_kernel.main(
        ["--gnn-checkpoint", str(results / "message_gnn_nr_2_0_4.msgpack"),
         "--corrected-checkpoint", str(results / "corrected_gnn_nr_2_0_4.msgpack")])
    torch.cuda.synchronize()
    launches = dict(fg.LAUNCHES)
    variants = out["variants"]
    ok = len(variants) == 6 and all(
        v["decision_agreement"] >= BENCH_MIN_AGREEMENT and launches[v["kernel"]] >= 1
        for v in variants.values())
    emit({"phase": "bench_gnn_kernel", **out, "launches": launches, "nvidia_smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"bench_gnn_kernel: a variant disagrees with the module or did "
                             f"not launch: {variants} {launches}")


PROBE_MXU_MAX_STEPS = 1.0  # the tensor cores' float32 sums need not round as IEEE adds do


def probe_phase(smi: str) -> list[dict]:
    """The aggregation probe at its defaults (nr_2_0_32 Z=32, h=64, L=10, 128
    frames): both variants against the plain version, timed."""
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.tools import probe_agg_mxu as pm

    for key in pm.LAUNCHES:
        pm.LAUNCHES[key] = 0
    out = pm.main([])
    torch.cuda.synchronize()
    launches = dict(pm.LAUNCHES)
    res = out["results"]
    ok = (res["vpu"]["identical"] and res["mxu"]["bf16_steps"] <= PROBE_MXU_MAX_STEPS
          and all(r["identical_on_exact"] for r in res.values())
          and min(launches.values()) >= 1)
    cfg = out["config"]
    qc = qc_layout(get_base_graph(cfg["code"]), cfg["Z"])
    h, L, frames = cfg["hidden"], cfg["iters"], out["frames"]
    feats = pm.random_features(qc, h, frames, torch.device("cuda"))
    plain_ms, _ = cuda_ms(lambda: pm.reference(feats, qc, L), reps=1)
    # Least time: the features read and written once, against the float32
    # additions and multiplications of the means.
    E, M = qc.num_edges, qc.num_base_rows * qc.Z
    t_bytes = 2 * frames * qc.num_base_edges * h * qc.Z * 2 / PEAK_BYTES * 1e3
    t_ops = L * frames * (E + M) * h / PEAK_F32_OPS * 1e3
    bms, bby = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    emit({"phase": "probe", **out, "launches": launches, "plain_ms": plain_ms, "bound_ms": bms,
          "bound_by": bby, "nvidia_smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"probe: a variant disagrees with the plain version or did not "
                             f"launch: {res} {launches}")
    return [{"name": "probe_agg", "route": "cuda",
             "source": "ldpc_tpu_torch/ops/csrc/probe_agg_mxu.cu",
             "replaces": "tools/probe_agg_mxu.py:48", "launches": sum(launches.values()),
             "max_abs_err": max(r["max_abs_err"] for r in res.values()),
             "ms": res["vpu"]["ms"], "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
             "library_ms": None, "variants_ms": {v: r["ms"] for v, r in res.items()},
             "us_per_frame_iteration": {v: r["us_per_frame_iteration"] for v, r in res.items()}}]


# ---------------------------------------------------------------------------
# Training and comparative evaluation
# ---------------------------------------------------------------------------

# The flagship fine-tune of results/README.md: the corrected GNN at T=10,
# h=64, injection, nr_2_0_32 Z=32, from the ft3 checkpoint; bf16 compute,
# Adam at 3e-4 on the cosine schedule, grad_clip 1.0, SNR uniform in
# [-4, -1] dB, random codewords, batch 64; 20 updates in chunks of 10.
TRAIN_FT = dict(T=10, H=64, steps=20, chunk=10, checkpoint="corrected10_gnn_nr_2_0_32_ft3.msgpack",
                kw=dict(batch_size=64, learning_rate=3e-4, snr_range=[-4.0, -1.0],
                        optimizer="adam", grad_clip=1.0, lr_schedule="cosine"))
TRAIN_SERVE = dict(B=2048, SNR=0.0, llr_seed=11)  # B4 against the module
TRAIN_CONFIDENT = 0.05  # |p - 0.5| above which the module's decision counts
TRAIN_MIN_AGREEMENT = 0.999
TRAIN_REMAT_LOSS_RTOL = 1e-5  # the first update's loss with and without remat
# The trained min-sum: OMS(10, per-iteration) from results/, 20 Adam updates
# at batch 4096 (tools/train_flagship.py's rate), then B3 on nms_main's batch.
TRAIN_NMS = dict(steps=20, chunk=10, checkpoint="oms10_per_iter_nr_2_0_32.msgpack",
                 kw=dict(batch_size=4096, learning_rate=1e-3, snr_range=[-4.0, -1.0],
                         optimizer="adam"), serve_B=65536, serve_snr=-3.0)
# The node GNN at the reference defaults (ldpc_tpu/config.py): SGD, momentum
# 0.9, weight decay 1e-4, lr 1e-3, 2 epochs over 4 SNRs at batch 256.
TRAIN_NODE = dict(T=5, L=2, epochs=2, B=256, lr=1e-3, snrs=[-2.0, 0.0, 2.0, 4.0])
TRAIN_EVAL = dict(snrs=[-3.0, -2.0, -1.0], B=4096, trials=2)


def flagship_trainer(remat: bool, seed: int):
    """The T=10 corrected GNN loaded from the ft3 checkpoint through the
    trainer, on the card, drawing random codewords from its own generator."""
    from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix, get_base_graph, qc_layout
    from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder
    from ldpc_tpu_torch.ops import qc_msg
    from ldpc_tpu_torch.training import LDPCDecoderTrainer

    f = TRAIN_FT
    plan = qc_msg.make_plan(qc_layout(get_base_graph("nr_2_0_32"), 32))
    model = create_corrected_minsum_gnn_decoder(plan, num_iterations=f["T"], hidden_dim=f["H"],
                                                input_injection=True, remat=remat)
    enc = encoder_from_H(expand_base_matrix(get_base_graph("nr_2_0_32"), 32))
    trainer = LDPCDecoderTrainer(model, plan, seed=seed, encoder=enc)
    trainer.load_model(Path(__file__).resolve().parent / "results" / f["checkpoint"])
    return trainer


def timed_train_steps(trainer, steps: int, chunk: int, kw: dict) -> dict:
    """``train_steps`` with a CUDA event at the start and after each chunk
    (``checkpoint_fn``), the peak device memory reset before: ms per update
    of each chunk, the peak, the losses."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()

    def mark():
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    trainer.train_steps(steps, scan_steps=chunk, checkpoint_fn=mark, log=None, **kw)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) / chunk for a, b in zip(marks, marks[1:])]
    losses = trainer.train_losses[-steps:]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    return {"ms_per_step_by_chunk": ms, "ms_per_step": ms[-1],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(), "losses": losses}


def trace_train() -> dict:
    """One update of the flagship fine-tune (remat) under the profiler, after
    two warm-up updates: the device time of its 12 costliest kernels, all
    kernels' time and launches, and the device's busy share of the wall."""
    trainer = flagship_trainer(remat=True, seed=1)
    kw = TRAIN_FT["kw"]
    trainer.train_steps(2, scan_steps=1, log=None, **kw)
    out = trace_split(lambda: trainer.train_steps(3, scan_steps=1, log=None, **kw), "train")
    top = sorted(out["kernels"].items(), key=lambda kv: -kv[1]["device_ms"])[:12]
    return {"phase": "trace_train", "updates": 1, "wall_ms": out["wall_ms"],
            "device_ms": out["device_ms"], "busy_share": out["device_ms"] / out["wall_ms"],
            "launches": sum(k["launches"] for k in out["kernels"].values()),
            "kernels": len(out["kernels"]), "top_kernels": dict(top)}


def resume_child() -> dict:
    """(b), in a process of its own (CUBLAS_WORKSPACE_CONFIG set before CUDA
    starts, deterministic algorithms on): 20 updates of the flagship
    fine-tune with the state saved after 10, a fresh trainer that loads it
    and takes the other 10, and the parameters of both compared."""
    import tempfile

    torch.use_deterministic_algorithms(True)
    f = TRAIN_FT
    with tempfile.TemporaryDirectory() as tmp:
        state = Path(tmp) / "state.pt"
        whole = flagship_trainer(remat=True, seed=5)

        def save():
            if whole.step == f["chunk"]:
                whole.save_state(state)

        whole.train_steps(f["steps"], scan_steps=f["chunk"], checkpoint_fn=save, log=None,
                          **f["kw"])
        resumed = flagship_trainer(remat=True, seed=6)  # other data: the state restores it
        resumed.load_state(state)
        resumed_from = resumed.step
        resumed.train_steps(f["steps"], scan_steps=f["chunk"], log=None, **f["kw"])
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    return {"phase": "train_resume", "deterministic_algorithms": True, "steps": f["steps"],
            "resumed_from": resumed_from, "parameters": len(a),
            "parameters_differing": differ,
            "max_abs_diff": max((a[k] - b[k]).abs().max().item() for k in a if a[k].numel()),
            "losses_identical": whole.train_losses == resumed.train_losses,
            "identical": not differ and whole.train_losses == resumed.train_losses}


def train_phase(smi: str) -> list[dict]:
    """18. train: the training path and the evaluator, with the weights it
    trains served through B4 and B3."""
    import os

    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.models import NeuralMinSumDecoder, make_base_graph_gnn_decoder
    from ldpc_tpu_torch.ops import fused_gnn as fg, fused_minsum as fm, fused_neural as fn
    from ldpc_tpu_torch.ops import qc_msg
    from ldpc_tpu_torch.parallel import trial_data, trial_generator
    from ldpc_tpu_torch.training import ComparativeEvaluator, LDPCDecoderTrainer
    from ldpc_tpu_torch.utils import compute_ber_fer, qpsk_awgn_llr
    from ldpc_tpu_torch.utils.metrics import REGISTRY

    f = TRAIN_FT
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    n = qc32.num_vars
    entries = []

    # (a) the flagship fine-tune, with remat and without, same data
    runs = {}
    for remat in (True, False):
        trainer = flagship_trainer(remat=remat, seed=1)
        runs[remat] = (trainer, timed_train_steps(trainer, f["steps"], f["chunk"], f["kw"]))
    trainer, with_remat = runs[True]
    without = runs[False][1]
    first_rel = abs(with_remat["losses"][0] / without["losses"][0] - 1.0)
    ok = (first_rel <= TRAIN_REMAT_LOSS_RTOL
          and with_remat["peak_memory_bytes"] < without["peak_memory_bytes"])
    emit({"phase": "train_flagship", "checkpoint": f["checkpoint"], "code": "nr_2_0_32", "Z": 32,
          "iterations": f["T"], "hidden_dim": f["H"], "steps": f["steps"], "chunk": f["chunk"],
          **{k: v for k, v in f["kw"].items()}, "compute_dtype": "bfloat16",
          "remat": with_remat, "no_remat": without,
          "peak_memory_ratio": without["peak_memory_bytes"] / with_remat["peak_memory_bytes"],
          "remat_time_ratio": with_remat["ms_per_step"] / without["ms_per_step"],
          "first_loss_rel_diff": first_rel,
          "train_steps_per_s": REGISTRY.gauges.get("train_steps_per_s"),
          "nvidia_smi": smi, "ok": ok})
    if not ok:
        raise AssertionError("remat changed the first loss or did not lower the peak memory")
    model = trainer.model
    del runs
    emit(trace_in_child("train"))

    # (b) resume, bit for bit, in a child with deterministic algorithms
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--resume-child"],
                          capture_output=True, text=True, timeout=600, env=env)
    if proc.returncode != 0:
        raise AssertionError(f"the resume child failed:\n{proc.stderr[-4000:]}")
    resume = json.loads(proc.stdout.strip().splitlines()[-1])
    emit({**resume, "ok": resume["identical"]})
    if not resume["identical"]:
        raise AssertionError("a resumed train_steps run differs from the uninterrupted one")

    # (c) the fine-tuned weights through B4 and through the module
    s = TRAIN_SERVE
    plan32 = trainer.plan
    dec = fg.make_fused_corrected_gnn_decoder_v2(qc32, model, f["T"], f["H"],
                                                 input_injection=True)
    llr = llrs(n, s["B"], s["SNR"], seed=s["llr_seed"])
    for key in fg.LAUNCHES:
        fg.LAUNCHES[key] = 0
    soft_k = dec(llr)
    torch.cuda.synchronize()
    launches = dict(fg.LAUNCHES)
    if launches["corrected_v2"] != 1:
        raise AssertionError(f"serving the fine-tuned GNN did not run corrected_v2: {launches}")
    with torch.no_grad():
        soft_m, _ = model(llr, plan32)
    confident = (soft_m - 0.5).abs() > TRAIN_CONFIDENT
    agreement = ((soft_k > 0.5) == (soft_m > 0.5))[confident].double().mean().item()
    ms = sorted(cuda_ms(lambda: dec(llr), reps=3)[0] for _ in range(3))[1]
    plain_ms, plain_out = cuda_ms(lambda: dec.plain(llr), reps=1)
    err = gnn_compare(dec, llr, "corrected_v2 fine-tuned T=10 whole batch", phase="train_serve",
                      kernel_out=soft_k, plain_out=plain_out)
    del plain_out
    conv = torch.full((s["B"],), float(f["T"]), device="cuda")
    bms, bby = gnn_bound_ms(qc32, f["H"], True, "corrected_v2", conv)
    ok = agreement >= TRAIN_MIN_AGREEMENT
    emit({"phase": "train_serve", "kernel": "corrected_v2", "batch": s["B"], "snr_db": s["SNR"],
          "launches": launches, "confident_share": confident.double().mean().item(),
          "confident_agreement": agreement,
          "module_max_abs_err": (soft_k - soft_m).abs().max().item(),
          "ms_per_batch": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
          "nvidia_smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"B4 on the fine-tuned weights agrees with the module on {agreement}"
                             f" of its confident decisions")
    del soft_m, soft_k
    entries.append({"name": "corrected_v2 (train: fine-tuned weights)", "route": "cuda",
                    "source": "ldpc_tpu_torch/ops/csrc/fused_gnn_tc.cu",
                    "replaces": "ldpc_tpu/ops/pallas_gnn.py:1791",
                    "launches": launches["corrected_v2"], "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None})

    # (d) the trained min-sum: fine-tuned by train_steps, served through B3
    m = TRAIN_NMS
    nms = NeuralMinSumDecoder(plan32, num_iterations=10, depth_L=2, weight_sharing="edge",
                              learnable_alpha=True, learnable_offset=True, per_iteration=True,
                              loss_mode="mean")
    nms_trainer = LDPCDecoderTrainer(nms, plan32, seed=2, encoder=trainer.encoder)
    nms_trainer.load_model(Path(__file__).resolve().parent / "results" / m["checkpoint"])
    nms_run = timed_train_steps(nms_trainer, m["steps"], m["chunk"], m["kw"])
    ndec = fn.make_fused_neural_minsum(qc32, nms, 10, 2, per_iteration=True)
    gen = torch.Generator(device="cuda").manual_seed(12)
    tx = trainer.encoder.random_codewords(gen, m["serve_B"])
    nllr = qpsk_awgn_llr(gen, tx, m["serve_snr"])
    for key in fn.LAUNCHES:
        fn.LAUNCHES[key] = 0
    bits = ndec(nllr)
    torch.cuda.synchronize()
    nlaunches = dict(fn.LAUNCHES)
    if ndec.route != "neural_group" or nlaunches["neural_group"] != 1:
        raise AssertionError(f"serving the fine-tuned min-sum did not run neural_group: "
                             f"{ndec.route} {nlaunches}")
    ber, fer = (float(x) for x in compute_ber_fer(tx, bits))
    nms_ms = sorted(cuda_ms(lambda: ndec(nllr), reps=3)[0] for _ in range(3))[1]
    nms_plain_ms, bits_p = cuda_ms(lambda: ndec.plain(nllr), reps=1)
    same = bool(torch.equal(bits, bits_p))
    nms_err = (bits - bits_p).abs().max().item()
    del bits_p
    nbms, nbby = nms_bound_ms(qc32, 10, 2, m["serve_B"])
    emit({"phase": "train_nms", "checkpoint": m["checkpoint"], "steps": m["steps"],
          **m["kw"], **nms_run, "route": ndec.route, "launches": nlaunches,
          "batch": m["serve_B"], "snr_db": m["serve_snr"], "ber": ber, "fer": fer,
          "whole_batch_identical": same, "ms_per_batch": nms_ms, "plain_ms": nms_plain_ms,
          "bound_ms": nbms, "bound_by": nbby, "nvidia_smi": smi, "ok": same})
    if not same:
        raise AssertionError("B3 on the fine-tuned min-sum differs from its plain version")
    entries.append({"name": "neural_group (train: fine-tuned min-sum)", "route": "cuda",
                    "source": "ldpc_tpu_torch/ops/csrc/fused_neural.cu",
                    "replaces": "ldpc_tpu/ops/pallas_neural.py:111",
                    "launches": nlaunches["neural_group"], "max_abs_err": nms_err, "ms": nms_ms,
                    "plain_ms": nms_plain_ms, "bound_ms": nbms, "bound_by": nbby,
                    "library_ms": None})
    del nms_trainer, nllr, tx, bits

    # (e) the node GNN at the reference defaults
    g = TRAIN_NODE
    node = make_base_graph_gnn_decoder(plan32, g["T"], g["L"])
    node_trainer = LDPCDecoderTrainer(node, plan32, seed=3)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    node_trainer.train(num_epochs=g["epochs"], batch_size=g["B"], learning_rate=g["lr"],
                       snr_range=g["snrs"], log=None)
    end.record()
    torch.cuda.synchronize()
    steps = g["epochs"] * len(g["snrs"])
    losses = node_trainer.train_losses
    ok = len(losses) == g["epochs"] and all(math.isfinite(x) for x in losses)
    emit({"phase": "train_node_gnn", "factory": "make_base_graph_gnn_decoder",
          "iterations": g["T"], "depth_L": g["L"], "epochs": g["epochs"], "batch": g["B"],
          "snr_range": g["snrs"], "optimizer": "sgd", "momentum": 0.9, "weight_decay": 1e-4,
          "learning_rate": g["lr"], "epoch_losses": losses,
          "ms_per_step": start.elapsed_time(end) / steps, "nvidia_smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"node GNN training gave losses {losses}")

    # (f) the evaluator: fused min-sum and BP on B1, the fine-tuned GNN
    e = TRAIN_EVAL
    kw = dict(snr_range=e["snrs"], batch_size=e["B"], num_trials=e["trials"])
    ev = ComparativeEvaluator(plan32, **kw)
    ev.add_min_sum(20, 0.75, qc=qc32, fused=True)
    ev.add_belief_propagation(50, qc=qc32, fused=True)
    ev.add_model("Corrected GNN 10it (fine-tuned)", model)
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    t0 = time.time()
    res = ev.evaluate_all(log=None)["decoders"]
    torch.cuda.synchronize()
    eval_s = time.time() - t0
    elaunches = dict(fm.LAUNCHES)
    plain_ev = ComparativeEvaluator(plan32, **kw)
    plain_ev.add_min_sum(20, 0.75)
    plain = plain_ev.evaluate_all(log=None)["decoders"]["Min-Sum Scaled"]
    ok = (res["Min-Sum Scaled"] == plain and elaunches["fused_retire"] >= 1
          and elaunches["retire_sumproduct"] >= 1)
    emit({"phase": "train_evaluator", **kw, "decoders": res, "plain_min_sum": plain,
          "fused_min_sum_equals_plain": res["Min-Sum Scaled"] == plain, "launches": elaunches,
          "seconds": eval_s, "nvidia_smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"evaluator: fused min-sum {res['Min-Sum Scaled']} against plain "
                             f"{plain}, launches {elaunches}")
    # The two B1 kernels on the evaluator's first trial, timed beside their
    # plain versions (these launches are not the path's).
    _, ellr = trial_data(trial_generator(ev.seed, 0, 0, "cuda"), n, e["B"], e["snrs"][0])
    for name, dec_, bound in (
            ("fused_retire", fm.make_fused_minsum(qc32, 20, 0.75, early_exit=True), bound_ms),
            ("retire_sumproduct", fm.make_fused_minsum(qc32, 50, 1.0, mode="sumproduct",
                                                       early_exit=True), bp_bound_ms)):
        kms, (_, kconv) = cuda_ms(lambda: dec_(ellr), reps=3)
        pms, pout = cuda_ms(lambda: dec_.plain(ellr), reps=1)
        kerr = compare(dec_, ellr, f"{name} evaluator trial 0, {e['snrs'][0]} dB", plain_out=pout)
        bms_, bby_ = bound(qc32, kconv)
        entries.append({"name": f"{name} (train: evaluator)", "route": "cuda",
                        "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
                        "replaces": "ldpc_tpu/ops/pallas_minsum.py:143",
                        "launches": elaunches[name], "max_abs_err": kerr, "ms": kms,
                        "plain_ms": pms, "bound_ms": bms_, "bound_by": bby_, "library_ms": None})
    return entries


# 18b-18d: the CLI, the data-parallel layer and the waterfall tool.
RESULTS = Path(__file__).resolve().parent / "results"
RATE_SIGMAS = 3.0  # combined binomial standard errors, counted on frame errors
# The CLI's workflow at full width: nr_2_0_32 Z=32, the tied neural min-sum,
# 2 epochs at batch 256 over 2 SNRs, 2 trials a point.
CLI_WORKFLOW = ["--base-graph", "nr_2_0_32", "--lifting-factor", "32", "--model-type", "tied",
                "--num-epochs", "2", "--batch-size", "256", "--snr-min", "-2", "--snr-max", "-1",
                "--snr-step", "1", "--num-trials", "2"]
# The CLI's compare on the flagship checkpoint at -3 dB, held against the JAX
# package's 1e9-bit record of the same model (a decode rate, not a speed).
CLI_FLAGSHIP = dict(snr=-3.0, batch=2048, trials=10, params=702870,
                    checkpoint="corrected10_gnn_nr_2_0_32_ft3.msgpack",
                    record="nr_2_0_32_corrected10_ft3_highprecision.json",
                    record_decoder="Corrected GNN 10it (trained)")
# shard_decode, the sharded sweep and the data-parallel step, in child worlds.
PARALLEL = dict(B=65536, SNR=3.0, iterations=20, llr_seed=21, sweep_snrs=[1.0, 2.0],
                sweep_trials=2, train_B=256, train_steps=2, train_rtol=1e-5)
PARALLEL_WORLDS = (("nccl", 1), ("gloo", 2))
WATERFALL_RECORD = "nr_2_0_32_minsum_highprecision.json"


def within_sigmas(rate: float, fer: float, frames: int, ref_rate: float, ref_fer: float,
                  ref_frames: int) -> float:
    """|rate - ref_rate| in combined binomial standard errors counted on
    frame errors (rate_sigma of each side)."""
    sigma = (rate_sigma(rate, fer, frames) ** 2
             + rate_sigma(ref_rate, ref_fer, ref_frames) ** 2) ** 0.5
    return abs(rate - ref_rate) / sigma if sigma > 0 else (0.0 if rate == ref_rate else math.inf)


def cli_phase(smi: str) -> None:
    """18b. cli: ``ldpc_tpu_torch.cli.main`` in this process: the workflow at
    full width (visualize where matplotlib imports), then compare on the
    flagship checkpoint at -3 dB against the JAX package's record."""
    import importlib.util
    import tempfile

    from ldpc_tpu_torch import cli

    has_matplotlib = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as tmp:
        wf = [*CLI_WORKFLOW, "--device", "cuda", "--model-path", f"{tmp}/model.pt",
              "--results-dir", f"{tmp}/workflow"]
        t0 = time.time()
        if has_matplotlib:
            cli.main(["workflow", *wf])
        else:
            for mode in ("train", "evaluate", "compare"):
                cli.main([mode, *wf])
        workflow_s = time.time() - t0
        out = Path(tmp) / "workflow"
        wf_res = json.loads((out / "comparison_results.json").read_text())
        values = [x for e in wf_res["decoders"].values() for k in ("ber", "fer") for x in e[k]]
        wf_ok = (list(wf_res["decoders"]) == ["Belief Propagation", "Min-Sum Scaled",
                                             "Neural (tied)"]
                 and len(wf_res["snr_range"]) == 2 and all(0.0 <= x <= 1.0 for x in values)
                 and (Path(tmp) / "model.pt").exists()
                 and (out / "evaluation_results.json").exists()
                 and (not has_matplotlib or (out / "combined_comparison.png").exists()))

        f = CLI_FLAGSHIP
        args = ["compare", "--device", "cuda", "--base-graph", "nr_2_0_32", "--lifting-factor",
                "32", "--model-type", "message_gnn_corrected", "--num-iterations", "10",
                "--hidden-dim", "64", "--model-path", str(RESULTS / f["checkpoint"]),
                "--random-codewords", "--modulation", "qpsk", "--snr-min", str(f["snr"]),
                "--snr-max", str(f["snr"]), "--batch-size", str(f["batch"]), "--num-trials",
                str(f["trials"]), "--no-compare-with-traditional", "--results-dir",
                f"{tmp}/flagship"]
        torch.cuda.synchronize()
        t0 = time.time()
        cli.main(args)
        torch.cuda.synchronize()
        flagship_s = time.time() - t0
        got = json.loads((Path(tmp) / "flagship" / "comparison_results.json").read_text())
    entry = got["decoders"]["Neural (message_gnn_corrected)"]
    record = json.loads((RESULTS / f["record"]).read_text())
    ref = record["decoders"][f["record_decoder"]]
    i = record["snr"].index(f["snr"])
    frames = f["batch"] * f["trials"]
    ref_frames = record["bits_per_point"] // 1664  # nr_2_0_32 at Z=32: n = 1664
    fer, ber = entry["fer"][0], entry["ber"][0]
    fer_sig = within_sigmas(fer, fer, frames, ref["fer"][i], ref["fer"][i], ref_frames)
    ber_sig = within_sigmas(ber, fer, frames, ref["ber"][i], ref["fer"][i], ref_frames)
    ok = (wf_ok and entry["param_count"] == f["params"] and fer_sig <= RATE_SIGMAS
          and ber_sig <= RATE_SIGMAS)
    emit({"phase": "cli", "workflow": {"args": CLI_WORKFLOW, "visualize_ran": has_matplotlib,
                                       "results": wf_res, "seconds": workflow_s, "ok": wf_ok},
          "flagship_compare": {"args": args[1:], "frames": frames, "ber": ber, "fer": fer,
                               "param_count": entry["param_count"],
                               "frame_errors": round(fer * frames),
                               "record": f["record"], "record_ber": ref["ber"][i],
                               "record_fer": ref["fer"][i], "record_frames": ref_frames,
                               "ber_sigmas": ber_sig, "fer_sigmas": fer_sig,
                               "seconds": flagship_s},
          "bar_sigmas": RATE_SIGMAS, "nvidia_smi": smi, "ok": ok})
    if not ok:
        raise AssertionError("the CLI's workflow or its flagship compare failed its checks")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_child(backend: str) -> dict:
    """One rank of a world set up in the environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT): shard_decode over fused_retire, the sharded
    mc_sweep over it and the data-parallel train step on the tied decoder,
    each against the unsharded call in this process."""
    import torch.distributed as dist

    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.models import make_tied_decoder
    from ldpc_tpu_torch.ops import fused_minsum as fm, qc_msg
    from ldpc_tpu_torch.parallel import (distributed_init, make_mesh, make_sharded_train_step,
                                         mc_sweep, shard_decode, trial_data, trial_generator)

    torch.backends.cuda.matmul.allow_tf32 = False
    distributed_init(backend=backend, timeout=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh()
    p = PARALLEL
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    plan = qc_msg.make_plan(qc32)
    fused = fm.make_fused_minsum(qc32, p["iterations"], 0.75)
    sharded = shard_decode(fused, mesh)
    llr = llrs(qc32.num_vars, p["B"], p["SNR"], seed=p["llr_seed"])
    launches = {}

    def counted(name, fn):
        for key in fm.LAUNCHES:
            fm.LAUNCHES[key] = 0
        out = fn()
        torch.cuda.synchronize()
        launches[name] = {k: v for k, v in fm.LAUNCHES.items() if v}
        return out

    def wall_ms(fn, reps: int = 5) -> float:
        fn()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    bits1, conv1 = counted("unsharded", lambda: fused(llr))
    bits_n, conv_n = counted("shard_decode", lambda: sharded(llr))
    decode_same = bool(torch.equal(bits_n, bits1)) and bool(torch.equal(conv_n, conv1))
    times = {"unsharded_ms": wall_ms(lambda: fused(llr)),
             "shard_decode_ms": wall_ms(lambda: sharded(llr))}
    del bits_n, conv_n

    kw = dict(snr_range=p["sweep_snrs"], batch_size=p["B"], num_trials=p["sweep_trials"],
              seed=5, modulation="bpsk")
    decode = lambda x: fused(x)[0]  # noqa: E731
    sweep_n = counted("mc_sweep", lambda: mc_sweep(decode, plan, mesh=mesh, **kw))
    sweep_1 = mc_sweep(decode, plan, mesh=None, **kw)

    train = {}
    for tag, m in (("sharded", mesh), ("single", None)):
        torch.manual_seed(0)
        model = make_tied_decoder(plan, 5, 2).cuda()
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        step = make_sharded_train_step(model, plan, opt, m, p["train_B"])
        losses = [step(torch.Generator(device="cuda").manual_seed(7 + k), 0.0).item()
                  for k in range(p["train_steps"])]
        train[tag] = (losses, {k: v.clone() for k, v in model.state_dict().items()})
    loss_rel = max(abs(a / b - 1.0) for a, b in zip(train["sharded"][0], train["single"][0]))
    param_rel = max(((train["sharded"][1][k] - v).abs() / v.abs().clamp_min(1e-30)).max().item()
                    for k, v in train["single"][1].items())
    out = {"phase": "parallel_rank", "backend": backend, "rank": rank, "world": world,
           "batch": p["B"], "rows": p["B"] // world, "shard_decode_identical": decode_same,
           **times, "sweep": sweep_n, "sweep_identical": sweep_n == sweep_1,
           "train_losses": train["sharded"][0], "train_loss_max_rel_diff": loss_rel,
           "train_param_max_rel_diff": param_rel, "launches": launches}
    if rank == 0 and backend == "nccl":  # the kernel against its plain version, B1's row
        err = compare(fused, llr, "fused_retire shard_decode batch, unsharded")
        kms = cuda_ms(lambda: fused(llr), reps=5)[0]
        pms = once_ms(lambda: fused.plain(llr))[0]
        bms, bby = bound_ms(qc32, conv1)
        out["kernel"] = {"max_abs_err": err, "ms": kms, "plain_ms": pms, "bound_ms": bms,
                         "bound_by": bby}
        # what every rank pays for drawing the whole batch: one trial's LLRs
        out["llr_draw_ms"] = cuda_ms(lambda: trial_data(trial_generator(5, 0, 0, "cuda"),
                                                        qc32.num_vars, p["B"], 1.0,
                                                        modulation="bpsk"), reps=5)[0]
    out["ok"] = (decode_same and out["sweep_identical"] and loss_rel <= p["train_rtol"]
                 and param_rel <= p["train_rtol"])
    dist.barrier()
    dist.destroy_process_group()
    return out


def run_world(backend: str, world: int) -> list[dict]:
    """parallel_child on ``world`` ranks of this script, the environment set
    by hand (one card: every rank on it); each rank's last line."""
    import os

    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0"}
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--parallel-child", backend],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, (stdout, stderr) in zip(procs, outs):
        if proc.returncode != 0:
            raise AssertionError(f"a {backend} rank failed (exit {proc.returncode}):\n"
                                 f"{stdout[-3000:]}\n{stderr[-4000:]}")
    return [json.loads(stdout.strip().splitlines()[-1]) for stdout, _ in outs]


def parallel_phase(smi: str) -> list[dict]:
    """18c. parallel: an NCCL world of 1 and two gloo ranks sharing the card,
    each rank in a child process."""
    worlds = {}
    for backend, world in PARALLEL_WORLDS:
        t0 = time.time()
        worlds[backend] = (run_world(backend, world), time.time() - t0)
    ok = all(r["ok"] for ranks, _ in worlds.values() for r in ranks)
    emit({"phase": "parallel",
          "worlds": {b: {"ranks": ranks, "seconds": s} for b, (ranks, s) in worlds.items()},
          "fused_retire_launches": {b: {r["rank"]: {path: n.get("fused_retire", 0)
                                                    for path, n in r["launches"].items()}
                                        for r in ranks}
                                    for b, (ranks, _) in worlds.items()},
          "train_rtol": PARALLEL["train_rtol"], "nvidia_smi": smi, "ok": ok})
    if not ok:
        raise AssertionError("a sharded path differs from its unsharded call")
    rank0 = worlds["nccl"][0][0]
    k = rank0["kernel"]
    return [{"name": "fused_retire (parallel: NCCL world of 1)", "route": "cuda",
             "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
             "replaces": "ldpc_tpu/ops/pallas_minsum.py:143",
             "launches": sum(n.get("fused_retire", 0) for path, n in rank0["launches"].items()
                             if path != "unsharded"),
             "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
             "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None}]


def waterfall_phase(smi: str) -> list[dict]:
    """18d. waterfall: ldpc_tpu_torch.tools.high_precision_curve at its
    defaults on fused_retire in throughput mode, every point against the
    JAX package's record."""
    import tempfile

    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_minsum as fm
    from ldpc_tpu_torch.parallel import trial_generator
    from ldpc_tpu_torch.tools import high_precision_curve as hpc
    from ldpc_tpu_torch.utils import bpsk_awgn_llr

    record = json.loads((RESULTS / WATERFALL_RECORD).read_text())
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    with tempfile.TemporaryDirectory() as tmp:
        res = hpc.main(["--out", f"{tmp}/curve.json"])
    torch.cuda.synchronize()
    launches = {k: v for k, v in fm.LAUNCHES.items() if v}
    n = 1664  # nr_2_0_32 at Z=32
    frames, ref_frames = res["bits_per_point"] // n, record["bits_per_point"] // n
    points = []
    for i, snr in enumerate(res["snr"]):
        ber, fer = res["ber"][i], res["fer"][i]
        rb, rf = record["ber"][i], record["fer"][i]
        points.append({"snr": snr, "ber": ber, "fer": fer, "frame_errors": res["frame_errors"][i],
                       "record_ber": rb, "record_fer": rf,
                       "ber_sigmas": within_sigmas(ber, fer, frames, rb, rf, ref_frames),
                       "fer_sigmas": within_sigmas(fer, fer, frames, rf, rf, ref_frames)})
    calls = len(res["snr"]) * res["trials_per_point"]
    ok = (res["snr"] == record["snr"] and res["bits_per_point"] == record["bits_per_point"]
          and launches == {"fused_retire": calls}
          and all(p["ber_sigmas"] <= RATE_SIGMAS and p["fer_sigmas"] <= RATE_SIGMAS
                  for p in points))
    emit({"phase": "waterfall", "bits_per_point": res["bits_per_point"],
          "trials_per_point": res["trials_per_point"], "batch": res["batch"],
          "iterations": res["iterations"], "kernel_calls": calls, "launches": launches,
          "points": points, "bar_sigmas": RATE_SIGMAS, "wall_seconds": res["wall_seconds"],
          "decoded_bits_per_s": res["decoded_bits_per_s"], "tool_nvidia_smi": res["nvidia_smi"],
          "nvidia_smi": smi, "ok": ok})
    if not ok:
        raise AssertionError("the waterfall differs from the JAX package's record")
    # The kernel in throughput mode on the -2 dB point's first batch, beside
    # its plain version (these launches are not the path's).
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    dec = fm.make_fused_minsum(qc32, res["iterations"], 0.75, track_convergence=False)
    i = len(res["snr"]) - 1
    llr = bpsk_awgn_llr(trial_generator(hpc.SEED, i, 0, "cuda"),
                        torch.zeros((res["batch"], n), device="cuda"), res["snr"][i])
    kms, (_, conv) = cuda_ms(lambda: dec(llr), reps=5)
    pms, pout = once_ms(lambda: dec.plain(llr))
    err = compare(dec, llr, f"fused_retire throughput mode, waterfall {res['snr'][i]} dB",
                  plain_out=pout)
    bms, bby = bound_ms(qc32, conv)
    return [{"name": "fused_retire (waterfall: throughput mode)", "route": "cuda",
             "source": "ldpc_tpu_torch/ops/csrc/fused_retire.cu",
             "replaces": "ldpc_tpu/ops/pallas_minsum.py:143", "launches": launches["fused_retire"],
             "max_abs_err": err, "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": bby,
             "library_ms": None}]


def build_all() -> tuple[dict, dict]:
    """Compile every CUDA source of the port, one nvcc per source, together;
    (each source's ptxas lines, each source's seconds)."""
    from ldpc_tpu_torch.ops import _build

    stems = ("fused_minsum", "fused_retire", "fused_gnn_tc", "fused_neural", "fused_neural_wide",
             "fused_neural_w128", "fused_msg_gnn_tc", "probe_agg_mxu", "probe_phi")

    def timed(stem: str) -> float:
        t0 = time.time()
        _build.build(stem)
        return round(time.time() - t0, 3)

    with ThreadPoolExecutor(len(stems)) as pool:
        seconds = dict(zip(stems, pool.map(timed, stems)))
    return {stem: [ln.strip() for ln in _build.build_log(stem).splitlines()
                   if "registers" in ln or "spill" in ln or "Function properties" in ln]
            for stem in stems}, seconds


def retire_smem_agree(qc32, qc384) -> dict:
    """Per retiring kernel, whether the library's shared-memory bytes equal
    the wrapper's for every plan the wrapper may take (nr_2_0_32 at Z=32,
    retire_zlane at Z=384)."""
    from ldpc_tpu_torch.ops import fused_minsum as fm

    rlib = fm.retire_kernel_library()
    dims = (32, qc32.num_base_rows, qc32.num_base_cols, qc32.num_base_edges)
    G = len(fm.row_groups(fm._structure(qc32))) - 1
    return {
        "fused_retire, retire_layered and their 64-bit and 128-bit words":
            wide_smem_agree(qc32, rlib),
        "retire_sumproduct": all(
            rlib.ldpc_retire_sumproduct_smem_bytes(*dims, p, f, s) ==
            fm.retire_sumproduct_smem_bytes(qc32, p, f, s)
            for p, f, s in fm.retire_sumproduct_plans(qc32)),
        "retire_layered_sumproduct": all(
            rlib.ldpc_retire_layered_sumproduct_smem_bytes(*dims, G, f) ==
            fm.retire_layered_sumproduct_smem_bytes(qc32, f)
            for _, f in fm.retire_layered_sumproduct_plans(qc32)),
        "retire_zlane, retire_zlane_layered, retire_zlane_sumproduct, "
        "retire_zlane_layered_sumproduct": zlane_smem_agree(qc384),
    }


def wide_smem_agree(qc, rlib) -> bool:
    """Whether the library's shared-memory bytes of fused_retire and
    retire_layered equal the wrapper's for every plan it may take, on the
    32-bit state word, the 64-bit one (the ``*_wide`` routes) and the
    128-bit one (the ``*_w128`` routes)."""
    from ldpc_tpu_torch.ops import fused_minsum as fm

    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
    G = len(fm.row_groups(fm._structure(qc))) - 1
    return all(
        all(rlib.ldpc_retire_smem_bytes(*dims, p, f, bits) == fm.retire_smem_bytes(qc, p, f, bits)
            for p, f in fm.retire_plans(qc, bits)) and
        all(rlib.ldpc_retire_layered_smem_bytes(*dims, G, f, bits) ==
            fm.retire_layered_smem_bytes(qc, f, bits) for _, f in fm.retire_layered_plans(qc, bits))
        for bits in fm.WORD_BITS)


def zlane_smem_agree(qc) -> bool:
    """Whether the library's shared-memory bytes of the four large-Z
    retiring kernels equal the wrapper's for every plan it may take."""
    from ldpc_tpu_torch.ops import fused_minsum as fm

    rlib = fm.retire_kernel_library()
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
    G = len(fm.row_groups(fm._structure(qc))) - 1
    return (all(rlib.ldpc_retire_zlane_smem_bytes(*dims, p) == fm.retire_zlane_smem_bytes(qc, p)
                for p in fm.retire_zlane_plans(qc))
            and all(rlib.ldpc_retire_zlane_layered_smem_bytes(*dims, G, f) ==
                    fm.retire_zlane_layered_smem_bytes(qc, f)
                    for _, f in fm.retire_zlane_layered_plans(qc))
            and all(rlib.ldpc_retire_zlane_sumproduct_smem_bytes(*dims, p) ==
                    fm.retire_zlane_sumproduct_smem_bytes(qc, p)
                    for p in fm.retire_zlane_sumproduct_plans(qc))
            and all(rlib.ldpc_retire_zlane_layered_sumproduct_smem_bytes(*dims, G, f) ==
                    fm.retire_zlane_layered_sumproduct_smem_bytes(qc, f)
                    for _, f in fm.retire_zlane_layered_sumproduct_plans(qc)))


def sass_mma_counts(stem: str) -> dict:
    """Per kernel in ``cuobjdump -sass`` of a built library, its HMMA
    (mma.sync) and HGMMA (wgmma) instructions: the products that run on the
    tensor cores."""
    from ldpc_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(stem))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):  # no HGMMA line holds "HMMA"
                if op in line:
                    counts[name][op] += 1
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="+", choices=["classical", "wide", "gnn", "nms", "nms_wide",
                                                  "msg_gnn", "tools", "train", "cli", "parallel",
                                                  "waterfall"], default=None)
    ap.add_argument("--trace", choices=["z384", "layered", "sumproduct", "gnn", "nms_large",
                                        "msg_gnn", "msg_gnn_v2", "msg_gnn_v3", "msg_gnn_v4",
                                        "train"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--resume-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--parallel-child", choices=["nccl", "gloo"], help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = args.only

    def runs(part: str) -> bool:
        return only is None or part in only

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    if args.trace is not None:  # the child of trace_in_child
        traces = {"z384": trace_z384, "layered": trace_layered, "sumproduct": trace_sumproduct,
                  "gnn": trace_gnn, "nms_large": trace_nms_large, "train": trace_train}
        emit(traces[args.trace]() if args.trace in traces else trace_msg_gnn(args.trace))
        return 0
    if args.resume_child:  # the child of train_phase's resume check
        emit(resume_child())
        return 0
    if args.parallel_child:  # a rank of parallel_phase's worlds
        emit(parallel_child(args.parallel_child))
        return 0

    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_gnn as fg, fused_minsum as fm, fused_neural as fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    started = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.time()
    ptxas, build_seconds = build_all()
    lib = fm.kernel_library()
    # Resident blocks per SM of the main-path kernels, from the CUDA runtime.
    occupancy = {}
    for code, Z in (("nr_2_0_32", 32), ("nr_2_0_32", 384)):
        qc = qc_layout(get_base_graph(code), Z)
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        if Z == 32:
            fpb = fm.pick_fused_batch_tile(qc)
            occupancy[f"fused Z={Z} frames_per_block={fpb}"] = lib.ldpc_fused_occupancy(*dims, fpb, 0, 0)
            parts, frames, per_sm = fm.retire_plan(qc, True)
            occupancy[f"fused_retire Z={Z} parts={parts} frames_per_block={frames}"] = per_sm
            parts, frames, per_sm = fm.retire_layered_plan(qc, True)
            occupancy[f"retire_layered Z={Z} parts={parts} frames_per_block={frames}"] = per_sm
            parts, frames, staged, per_sm = fm.retire_sumproduct_plan(qc, True)
            occupancy[f"retire_sumproduct Z={Z} parts={parts} frames_per_block={frames} "
                      f"staged_llrs={staged}"] = per_sm
            parts, frames, per_sm = fm.retire_layered_sumproduct_plan(qc, True)
            occupancy[f"retire_layered_sumproduct Z={Z} parts={parts} "
                      f"frames_per_block={frames}"] = per_sm
            for name in ("corrected_v2", "corrected"):
                occupancy[f"{name} Z={Z} h=64"] = fg.corrected_tc_plan(qc, 64, True, name)[1]
            for name in ("msg_gnn", "msg_gnn_v2", "msg_gnn_v3", "msg_gnn_v4"):
                occupancy[f"{name} Z={Z} h=64"] = fg.msg_gnn_tc_plan(qc, 64, False, name)[1]
            for name in WIDE_KINDS:
                occupancy[f"{name} Z={Z} h=128"] = fg.msg_gnn_tc_plan(qc, 128, False, name)[1]
            shared, fpb = fn.neural_plan(qc, 10, 2)
            occupancy[f"fused_neural Z={Z} T=10 L=2"] = fn.kernel_library().ldpc_neural_occupancy(
                *dims, 10, 2, fpb, int(shared))
            parts, frames, per_sm = fn.neural_group_plan(qc, 2, True)
            occupancy[f"neural_group Z={Z} L=2 parts={parts} frames_per_block={frames} "
                      f"staged_weights=True"] = per_sm
        else:
            occupancy[f"fused_zlane Z={Z}"] = lib.ldpc_zlane_occupancy(*dims, 0, 0)
            parts, per_sm = fm.retire_zlane_plan(qc, True)
            occupancy[f"retire_zlane Z={Z} parts={parts}"] = per_sm
            parts, frames, per_sm = fm.retire_zlane_layered_plan(qc, True)
            occupancy[f"retire_zlane_layered Z={Z} parts={parts} "
                      f"frames_per_block={frames}"] = per_sm
            parts, per_sm = fm.retire_zlane_sumproduct_plan(qc, True)
            occupancy[f"retire_zlane_sumproduct Z={Z} parts={parts}"] = per_sm
            parts, frames, per_sm = fm.retire_zlane_layered_sumproduct_plan(qc, True)
            occupancy[f"retire_zlane_layered_sumproduct Z={Z} parts={parts} "
                      f"frames_per_block={frames}"] = per_sm
    if min(occupancy.values()) < 1:
        raise AssertionError(f"a main-path kernel cannot be resident: {occupancy}")
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    smem_agree = retire_smem_agree(qc32, qc_layout(get_base_graph("nr_2_0_32"), 384))
    if not all(smem_agree.values()):
        raise AssertionError(f"a retiring kernel's shared memory differs from the wrapper's: "
                             f"{smem_agree}")
    mma = {stem: sass_mma_counts(stem) for stem in dict(TC_KERNELS.values())}
    if any(not counts or min(sum(c.values()) for c in counts.values()) < 1
           for counts in mma.values()):
        raise AssertionError(f"a tensor-core kernel has no tensor-core instructions: {mma}")
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "seconds_per_source": build_seconds, "ptxas": ptxas,
          **{f"{name}_ptxas": ptxas_of("fused_retire", f"{name}_kernel")
             for name in ("retire_minsum", "retire_layered", "retire_zlane_layered",
                          "retire_sumproduct", "retire_layered_sumproduct",
                          "retire_zlane_layered_sumproduct")},
          "retire_sumproduct_plan_nr_2_0_32_Z32": dict(zip(
              ("parts", "frames_per_block", "staged_llrs", "blocks_per_sm"),
              fm.retire_sumproduct_plan(qc32, True))),
          "retire_layered_sumproduct_plan_nr_2_0_32_Z32": dict(zip(
              ("parts", "frames_per_block", "blocks_per_sm"),
              fm.retire_layered_sumproduct_plan(qc32, True))),
          "retire_smem_bytes_agree": smem_agree,
          "blocks_per_sm": occupancy, "mma_per_kernel": mma,
          **{f"{kind}_shape": {f"nr_2_0_32 Z=32 h={h} inject={inj}":
                               tc_shape(qc32, h, inj, kind)
                               for h in (16, 64) for inj in (False, True)}
             for kind in TC_KERNELS},
          **{f"{kind}_h128_shape": {f"nr_2_0_32 Z=32 inject={inj}": tc_shape(qc32, 128, inj, kind)
                                    for inj in (False, True)}
             for kind in WIDE_KINDS}})

    entries = []
    seconds = {}

    def timed_phase(part: str, fn) -> None:
        t0 = time.time()
        entries.extend(fn() or [])
        seconds[part] = round(time.time() - t0, 1)
        emit({"phase": "seconds", "part": part, "seconds": seconds[part]})

    if runs("classical"):
        timed_phase("classical", lambda: classical_phases(lib, smi))
    if only is not None and "wide" in only:
        timed_phase("wide", lambda: wide_phases(smi))
    if runs("gnn"):
        timed_phase("gnn", lambda: gnn_phases(smi))
    if runs("nms"):
        timed_phase("nms", lambda: nms_phases(smi))
    if runs("nms_wide"):
        timed_phase("nms_wide", lambda: nms_wide_phase(smi))
    if runs("msg_gnn"):
        timed_phase("msg_gnn", lambda: msg_gnn_phases(smi) + msg_gnn_wide_phases(smi))
    if only is None:
        timed_phase("serve", serve_phase)
    def tools() -> list[dict]:
        bench_phase(smi)
        return probe_phase(smi)

    if runs("tools"):
        timed_phase("tools", tools)
    if runs("train"):
        timed_phase("train", lambda: train_phase(smi))
    if runs("cli"):
        timed_phase("cli", lambda: cli_phase(smi))
    if runs("parallel"):
        timed_phase("parallel", lambda: parallel_phase(smi))
    if runs("waterfall"):
        timed_phase("waterfall", lambda: waterfall_phase(smi))

    emit({"phase": "seconds", "part": "total", "seconds": round(time.time() - started, 1),
          "parts": seconds})
    # 19. kernels
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
