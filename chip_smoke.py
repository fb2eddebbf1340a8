#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/``), then runs the paper's four DiGraph tasks on an R-MAT "social"
graph at scale 21 (2,097,152 vertices, ~67M directed edges, the size of
SNAP's soc-LiveJournal1):

  load    COO -> CSR on the card (device sort + the degree_offsets kernel
          on the sorted sources), bit-identical to the host engine, timed
          after a warm-up (the cold call beside it) and split into the
          host conversions, the host->device copies and the device build;
          CSR -> DiGraph arena
  load_file
          the raw CSR written as a 2.15 GB MTX file (write_mtx, untimed,
          under build/, deleted after the phase), then load_mtx and
          load_digraph from it (the compiled row parser asserted, each
          timed after a warm-up and split into the host parse, the copies
          and the device build); the loaded CSR bit-identical to the raw
          one, the loaded arena to DiGraph.from_csr of it
  clone   deep copy, equal buffers
  update  deletion (1e-3 |E|), insertion (1e-3 |E|) and mixed (1e-2 |E|)
          batches through the merge_rows_fused kernel (gather, merge and
          write-back in one launch a width group), each held bit for bit
          against a twin graph run on the plain PyTorch merge; a snapshot
          taken first must not change; each batch timed after a warm-up
          apply of the same plan on a copy (timed too, as the batch's
          first call), and split into fused_apply's launches (CUDA
          events: the operands' copy and the merges) and the rest of
          apply (host planning, the wait for the merge counts, their
          install)
  walk    the 42-step reverse walk (timed; unnormalised it overflows f32),
          and the normalised walk held against the plain tile cumsum
  walk_slotted
          the interval-less 42-step walk over the same arena through the
          slot_walk_partials kernel (timed), one walk and four batched,
          held against the plain partials and the image walk; the split
          of one step (gather, partials, seam fold)
  stream  the paper's tasks on the other four representations (SortedCOO,
          LazyCSR, ChunkedGraph, Vector2D), one at a time, each loaded on
          the card from the same CSR (timed, and its clone): a sealed
          generation builds its walk image, then the update phase's three
          batches are replayed, each applied (timed) and followed by a
          42-step walk through walk_flush, which patches the image
          (merge_rows_fused) and walks it (tile_cumsum) with one host wait;
          the walk after the mixed batch timed and split by CUDA events
          into the patch (fused_apply's launches) and the steps
          (slot_walk_multi_blocked, queued after them).  Each is held against the DiGraph
          of the update phase (to_csr bit for bit, the normalised walk),
          its patched image against a fresh build (live rows bit for bit)
          and against a twin patched with the plain versions (bit for bit),
          its image audited and its sealed generation unchanged; every walk
          after the first patches (no build, no rebuild) unless one of
          repro's rebuild rules fires, which the phase prints
  durable crash recovery at the social graph's full size: a DiGraph
          loaded from the same CSR is wrapped in a DurableGraph (WAL and
          differential checkpoints under build/, deleted after the phase;
          the constructor's step-0 full checkpoint timed), then 8 rounds
          of mixed plans (1e-2 |E| each, drawn as
          benchmarks/bench_recovery.py draws them): rounds 1-4 through
          apply, a differential checkpoint (timed, its persisted chunks
          counted), rounds 5-6 through one group commit (one journal
          flush), round 7 crashed at durable.post_append; recover on the
          card (restore and replay timed, the replay through
          merge_rows_fused), the audit timed alone; the recovered graph's
          state_tree (every slot), to_csr and 42-step walk bit for bit
          against an uncrashed twin on the card, and again after round 8
          on both.  Then SortedCOO, LazyCSR, ChunkedGraph and Vector2D at
          scale 16, each crashed at durable.post_apply on its 4th plan and
          recovered on the card: to_csr and state_tree bit for bit against
          a card twin, the walks (rebuilt image against the twin's patched
          one) normalised at rtol 5e-4
  serve   walk serving on the card (runtime/serve.py's WalkServer, one
          writer and one dispatcher thread on the default stream) over
          clones of the update phase's DiGraph, with
          benchmarks/bench_serve.py's knobs and warm-up (4-step walks from
          4 seeds, an update of 256 every 10 requests, every 4th a
          deletion batch, seed 13, batches of at most 16): steady (240
          requests 2 ms apart, queue 256), overload (480 open loop,
          deadline 0.25 s, queue 32), fault (slot_walk.cuda armed twice:
          served by retries on the same backend), a persistent
          slot_walk.cuda fault (the ticket fails visibly) and serve.seal
          armed once (a reader served the previous generation while the
          writer waits to retry; the writer's apply copied before writing).
          Each level holds the zero-lost ledger and checks a 25% sample of
          its served walks (every one for the last two) against the card's
          GenerationOracle at their own generations; no plain tile cumsum
          runs.  Latency percentiles, throughput, the seal's host time and
          the update acks are timed; one B = 16 batch is timed by CUDA
          events, and its batched tile_cumsum held against the plain one
  sharded the social CSR cut into 4 shards on the one card (shard_csr,
          timed; the bytes each shard holds printed), gather_csr bit for
          bit against the CSR; one and 16 batched 4-step walks held against
          the DiGraph image walk of the same CSR (rtol 1e-4, 5e-4 on rows of
          degree >= 128, plus 1e-6 of the walk's largest visit), the 42-step
          walk timed (one tile_cumsum a shard a step) beside the DiGraph
          image's, and both profiled for their kernels' device time; the
          update phase's three plans routed through apply (the mixed one
          timed), then gather_csr bit for bit against the DiGraph's to_csr;
          a DurableGraph(diff=True) over it (full and differential
          checkpoints timed), three more plans, a crash at
          durable.post_append, recover(parallel=True) on the card (timed),
          every shard's state_trees() bit for bit against an uncrashed twin;
          on the recovered graph a shard.patch fault (the shard quarantined,
          its subplan spooled, the rest patched), the degraded walk (exact
          zeros on the down rows, the rest against a masked float64 walk), a
          dst corruption caught by the structural audit and a wgt one only by
          audit_shard with integrity on (both on a copy), the down shard
          rebuilt (rebuild_shard, timed) back to coverage 1, gather_csr bit for bit
          against the twin; then a WalkServer over the twin: 120 four-step
          walks with updates and one shard.walk fault, the shard quarantined
          and later responses at coverage < 1, zero lost, every served walk
          checked against the oracle with its down rows masked (p50/p99
          timed); no plain tile cumsum or row merge runs
  mesh    the sharded graph on a torch.distributed mesh: 4 ranks, one
          shard each, spawned on the one card over gloo (4 ranks on one
          card, not a multi-card figure), each holding only its own shard;
          the local mode runs the same steps first and writes the CSR's
          host arrays and its results under build/ (deleted after the
          phase).  Every rank: shard_csr (timed), gather_csr bit for bit
          against the CSR, the 42-step walk (timed, with the exchange's
          host time and the step's event time) and a B = 16 batch (CUDA
          events) bit for bit against the local mode's, exchange bytes of
          exactly 3 x 524,288 x B x 4 a step; the update phase's plans
          routed (a patch on a rank only if routed there, the mixed one
          timed) and gather_csr bit for bit against the DiGraph's to_csr; a
          DurableGraph over the mesh (step-0 checkpoint timed), a
          shard.walk fault armed on rank 2 raised as ShardFaultError(2) on
          every rank, the degraded walk at coverage 0.75 bit for bit
          against the local mode's, rebuild_shard (timed); three durable
          plans, a crash at durable.post_append, recover(mesh=) (timed)
          bit for bit against an uncrashed twin's state_trees; a growth
          plan re-sharding every rank (timed) and its walk bit for bit;
          then serving the grown graph (a checkpoint first, the rebuild's
          base): rank 0's WalkServer, the other ranks following it through
          the op channel.  A closed loop (walk, an acked update, walk, the
          walk whose shard.walk fault on rank 2 is served degraded on its
          retry, rebuild_shard(2) through run_on_writer, walk) bit for bit
          against the same loop through a local-mode server (responses,
          generations, coverage, down shards, the counters); then the
          sharded phase's open-loop level (120 walks 2 ms apart, an update
          of 256 every 10, a shard.walk fault on rank 1), zero lost and no
          torn read against the per-generation oracle, after one B = 16
          batch timed; tile_cumsum and merge_rows_fused launched in the
          serving on every rank; the [mesh_serve] line (p50/p99, req/s,
          ack p99, the batch, ops a rank).  The ranks' kernel launches
          added to the path's
  walk_bsr
          a road graph at scale 24 (16,777,216 vertices, ~36.9M directed
          edges, the class of SuiteSparse's asia_osm) re-blocked into
          128x128 BSR tiles on the card (~393K tiles, ~25.8 GB), and the
          42-step walk as iterated bsr_spmm launches (timed), held against
          the plain SpMM walk and the road DiGraph's walks
  segment_sum
          GNN neighbour aggregation over the social CSR (each edge's row,
          its destination's features drawn from the seed) at D = 16 and
          D = 64 through the edge_segment_runs kernels, which read the
          edges in place (timed, with its peak memory, beside the library
          index_add_), held against float64 sums, the library index_add_
          and the plain op, and bit for bit against itself; at D = 16
          also on small-integer messages, whose sums are exact, bit for bit
          against index_add_ (every row, the hubs' ~150-tile seam walks
          included); the CUDA path must not synchronise, pad or fold
  two_tower
          the two-tower retrieval model at its FULL width (two 10M x 256
          tables, towers 1024-512-256) serving serve_p99 (512 pairs),
          serve_bulk (262,144 pairs) and retrieval_cand (one query, 10^6
          candidates) through the embedding_bag kernel (timed, on full
          bags), held against the plain bag (on ragged bags as well), the
          tiled-query serve and the library embedding_bag; each tower's
          bag time against its MLP time
  transformer
          h2o-danube-1.8b at full width (24 layers, d_model 2560, 32/8
          heads of 80, window 4096, random weights from the seed) with
          attn_impl="flash": one 32,768-token prefill (prefill_32k, batch
          cut to 1) through 24 flash_attention launches, all on its
          tensor-core (wgmma) kernel (timed, with the kernels' share),
          held against the plain attention at 8,192 tokens (in float32;
          in bfloat16, the distance from the float32 model against that
          of the bfloat16 model with the plain attention); the kernel's
          TFLOP/s on the visible pairs beside SDPA's flash backend on plain
          causal attention at the same shape (a yardstick); decode_32k
          (batch 128 against a 4,096-slot bfloat16 ring filled from the
          seed, 8 greedy steps timed); prefill against 64 decode steps in
          float32
  gnn_train
          (run second, after model_shard, on an emptied card)
          the GNN family trained at each config's FULL width through
          launch.steps.build_cell (the build and the steps counted as the
          main path): gcn-cora on ogb_products (2,449,408 nodes, 61,859,328
          edges, 3 AdamW steps), graphcast on minibatch_lg (a 233,472-vertex,
          114,616,320-edge CSR built on the card by from_coo, 1,024 seeds
          sampled 15-10 a step, 16 layers at d = 512 in float32, 2 steps),
          schnet and mace on molecule (128 molecules of 30 atoms and 64
          edges, 2 steps, and MACE's forces); every aggregate one
          edge_segment_runs launch after a stable sort of its destinations
          (counted; the plain pieces never called; one sort a graph, or a
          step for the sampled subgraph).  Each step timed by CUDA events,
          with the cell's peak memory; the losses finite and the parameters
          changed; the first step's loss and the model's outputs against
          the same through the plain segment sum on the card (float32,
          within 1e-5), two forwards bit for bit; the largest aggregate of
          each cell timed (kernel, op, sort) beside index_add_ on the same
          messages and held against it within 2*gamma(deg)*sum|terms|; the
          SMOKE gcn-cora cell's steps on the card against the CPU
  lm_train
          (run third, right after gnn_train, on an emptied card)
          LM and two-tower training at full width and the large LMs'
          prefills, each cell built by launch.steps.build_cell:
          h2o-danube-1.8b train_4k at all 24 layers (remat, the blocked
          attention, bf16 Adam moments), its step cut from 16 microbatches
          of 16 x 4,096 tokens to 2 of 2 (2 AdamW steps, then one through
          the int8 error-feedback compressor); qwen3-moe-235b-a22b cost1
          (one layer at full width: 128 experts, top 8, bf16 params) train
          on one 4,096-token sequence, its aux loss and dropped share; the
          cost1 prefill_32k of qwen3-moe, arctic-480b (dense residual),
          qwen2-72b (qkv bias) and mistral-large-123b (batch cut to 1) with
          attn_impl="flash", one flash_attention launch each on the wgmma
          kernel at D = 128 and GQA groups 16 / 7 / 8 / 12, each layer's
          q/k/v held against the plain attention; qwen3-moe cost1
          decode_32k (batch 128, 4 greedy steps against a 32,768-slot
          cache filled from the seed); two-tower train_batch at FULL width
          with both vocabularies cut to 5M rows and the batch to 16,384 (2
          AdamW steps, two embedding_bag launches a step; the first step's
          loss and sampled table-grad rows against the plain bag's, 1e-5 of
          their max; the pooled fields against the plain bag).  Every step
          timed by CUDA events, with the cell's peak memory, tokens/s and
          the model FLOPs' share of 989 TFLOP/s; losses finite and every
          parameter leaf changed

  model_shard
          (run first, right after the build: its processes need the card
          empty of the main process's cached memory) model sharding
          over a (2, 2) ("data", "model") DeviceMesh of 4 ranks spawned on
          the one card over gloo (not a multi-card figure): gcn-cora x
          ogb_products (edges over every axis, edge_segment_runs on each
          rank's edges), two-tower train_batch at full width (vocabularies
          cut to 2M rows: SHARD_TT_ROWS; the table's rows over "model",
          embedding_bag on each rank's rows), h2o-danube-1.8b train_4k cost2
          (2 microbatches of 2 x 4,096 tokens; FSDP over "data", TP over
          "model"), prefill_32k cost2 (batch 1, flash_attention on each
          rank's 16 q / 4 kv heads), h2o-danube-1.8b decode_32k cost2
          (batch 128, 64 a data rank, against the 4,096-slot bf16 ring
          filled from the seed, 2,048 slots a model rank: context-parallel
          decode, each rank's slice merged by one all-reduce max and one
          sum a layer; a timed step at position 32,768, the ring wrapped,
          and one at 1,500, the live prefix in model rank 0's slice) and
          gcn-cora x minibatch_lg (the 114.6M-edge CSR, 1,024 seeds over
          every axis sampled 15-10 on each rank, the picks all-gathered,
          the subgraph placed over every axis, edge_segment_runs on each
          rank's edges).  The ranks build at once: each draws the full
          gcn, h2o and sampled cells from the seed and keeps its shards,
          and only its own rows of two-tower's tables (drawn in seeded
          blocks of rows); a warm-up step and a timed one (CUDA events,
          peak, collective bytes and counts by kind, kernel launches,
          which must be above 0 on every rank).  Held against the same
          cells run unsharded on the card in a process of their own: the
          losses; the float32 cells' first grads and their parameters
          after the two steps, each leaf's RMS distance and the share of
          elements beyond ROADMAP.md section 3's elementwise tolerances
          within the cell's limits (SHARD_F32_LIMITS; the sampled cell
          gcn's, its subgraph bit for bit); the decode steps' logits and
          written slots by section 3's bf16 bound against the unsharded
          float32 decode (every slot no step wrote bit for bit as drawn);
          the bf16 train cell's parameters (each
          leaf within a quarter of its change); the prefill's logits
          (section 3's bf16 bound against the unsharded model through the
          plain attention, and against the same sharded model through the
          plain attention).  The same cells dry-run on a fake
          (2, 2) mesh (launch.dryrun) give the ranks' argument and
          collective bytes exactly; the production 16x16 dry run of
          h2o-danube-1.8b train_4k (cost2/cost4/opt1/opt2), mace x
          ogb_products (chunk2/chunk4), h2o-danube-1.8b decode_32k
          (cost2/cost4) and gcn-cora x minibatch_lg prints their roofline
          terms (launch.roofline: H100 data-sheet constants, modelled)

then holds each kernel against its plain PyTorch version at the shapes its
path gave it and times both (tile_bases at the batched walk's shape: 16
planes of the walk's tiles, against float64 cumsum; slot_gather at 16 rows
of visits over the walk's index and at one row over the road image's, bit
for bit, with index_select as the yardstick).  The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
Any failed check raises, so the exit code is non-zero and no result line
is printed.  Without a CUDA device it exits non-zero at once.
"""
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

SCALE = 21
EDGE_FACTOR = 16
SEED = 42
WALK_STEPS = 42
#: the road graph of the BSR walk: 2^24 vertices
ROAD_SCALE = 24
#: H100 SXM device-memory rate (NVIDIA data sheet) for the byte bounds
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM non-tensor float32 rate, used for the operation bounds
VECTOR_OPS_PER_S = 67e12
#: H100 SXM dense bfloat16 tensor-core rate: flash_attention's bound (its
#: bfloat16 inputs make every product exact in float32, so the tensor
#: cores could do its work)
TENSOR_BF16_OPS_PER_S = 989e12
#: normalised walks, kernel vs plain intra-tile scan: rtol is the hub-row
#: envelope of the uncompensated intra-tile level; the visits are <= 1 and a
#: row whose exact sum is 0 keeps the rounding residue of its tile's prefix
#: (~ulp of the tile sum, added in another order), hence the small atol
WALK_RTOL, WALK_ATOL = 5e-4, 1e-6
#: unnormalised walks whose steps sum only non-negative terms, in another
#: order (the road graph's BSR walk against its plain version and against
#: the interval-less walk): no cancellation, a few ulps a step
EXACT_WALK_RTOL = 1e-4
#: slot_walk_partials: a run of n <= 128 non-negative terms summed in two
#: orders; each is within (n-1)*2^-24 of the exact sum
PARTIALS_RTOL = 2 * 127 * 2.0**-24
#: bsr_spmm: each output sums the few non-zero products of a row in
#: another order (non-negative terms)
SPMM_RTOL = 1e-5
#: kernels that no main path launches: count_degrees is the histogram of
#: unsorted sources, and the device build reads its sorted sources with
#: degree_offsets instead; it is held against its plain version all the same
OFF_PATH = ("count_degrees",)
#: the segment sum's widths: gcn-cora's and schnet's d_hidden
SEG_WIDTHS = (16, 64)
#: the width whose edge_segment_runs launch fills the kernels line
SEG_ROW_D = 16
#: float32 unit roundoff: a sum of n terms in any order is within
#: (n-1)*U*sum|terms| of the exact sum
U = 2.0**-24
#: two-tower serving scores, bag kernel against the plain bag (the same
#: MLP on pooled inputs that differ in the last bits)
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
#: host-synced serve_p99 calls whose 50th and 99th percentiles are printed
P99_CALLS = 200
#: pairs of ragged bags (empty bags included) checked against the plain bag
RAGGED_BATCH = 4096
#: prefill_32k's batch of 32 sequences cut to 1: the batch's logits alone
#: would be 67 GB
PREFILL_BATCH = 1
#: prompt length of the model-level check against the plain attention
#: (longer than the 4,096-key window)
LM_CHECK_LEN = 8192
#: the model-level check runs in float32, where the kernel and the plain
#: attention differ only in the order of their f32 sums (at worst
#: gamma_4096 = 2^-12 of max|v| a layer, ~1e-6 relative in practice); the
#: bfloat16 model's logits differ from its plain-attention twin's by
#: compounding one-ulp rounding flips (280 of 262,144,000 logits beyond
#: 2^-4 at 8,192 tokens on the FMA kernel), so that comparison is printed
LM_CHECK_TOL = 1e-3
#: the bfloat16 model is held against the float32 model with the plain
#: attention instead: the RMS distance of its logits (through the kernel)
#: may exceed that of the bfloat16 model with the plain attention by at
#: most this factor.  Both distances come from the bfloat16 roundings of
#: every projection and attention output; the kernel's own error (~2^-17
#: relative, the hi/lo split of p) is far below them
LM_BF16_RMS_RATIO = 1.10
#: greedy decode steps timed after a warm-up step
DECODE_STEPS = 8
#: the serve phase: benchmarks/bench_serve.py's knobs (walk steps, seeds a
#: request, an update batch of 256 every 10 requests, every 4th a deletion
#: batch, traffic seed 13, verify seed 7, a 25% verified sample, batches of
#: at most 16) and its load levels
SERVE_STEPS, SERVE_SEEDS, SERVE_UPDATE_EVERY, SERVE_UPDATE_SIZE = 4, 4, 10, 256
SERVE_SEED, SERVE_VERIFY_SEED, SERVE_VERIFY, SERVE_BATCH = 13, 7, 0.25, 16
SERVE_LEVELS = {
    "steady": dict(requests=240, submit_gap_s=0.002, timeout=None, max_queue=256),
    "overload": dict(requests=480, submit_gap_s=0.0, timeout=0.25, max_queue=32),
    "fault": dict(requests=120, submit_gap_s=0.0, timeout=None, max_queue=256),
}
#: the seal level's writer pause after a failed seal: the window in which a
#: reader must be served the previous generation
SERVE_SEAL_BACKOFF_S = 0.5
#: the sharded phase: shards of the social graph (ROADMAP.md §1 item 1's
#: 2-8 on one card), the size of its durable and failover plans (mixed,
#: this fraction of |E| inserted and as many deleted) and its serving
#: traffic (bench_serve's knobs, 120 requests, one shard.walk fault)
SHARDS, SHARD_PLAN_FRAC, SHARD_SERVE_REQUESTS = 4, 1e-3, 120
#: the mesh phase: its ranks (one shard each, all on the one card over
#: gloo) and their deadline; every collective fails after 120 s
MESH_RANKS, MESH_TIMEOUT_S = SHARDS, 420
#: the mesh phase's serving: the closed loop's walks before the one whose
#: shard.walk fault fires on shard 2, the local-mode loop's retry pause
#: (its writer reseals degraded first; on the mesh the retry waits for the
#: writer's round instead, after the default pause), the open-loop level's
#: faulted shard and the walks on it before its fault, and how long any
#: ticket may take
MESH_SERVE_FAULT_WALKS, MESH_SERVE_BACKOFF_S = 2, 0.5
MESH_OPEN_FAULT_SHARD, MESH_OPEN_FAULT_AFTER, MESH_SERVE_WAIT_S = 1, 2, 120.0
#: rows whose block spans at least a tile: the walk's hub-row band
#: (ROADMAP.md §3) applies to them, the plain rtol to the rest
HUB_DEGREE = 128
#: prefill against decode: prompt length, batch and the tolerance of
#: repro's own check (tests/test_models.py:46; the bfloat16 cache rounds
#: K and V that forward keeps in float32)
PD_LEN, PD_BATCH, PD_TOL = 64, 2, 2e-2
#: the gnn_train phase: (arch, shape, train steps), each at its config's
#: FULL width, built by launch.steps.build_cell as a user builds it
GNN_CELLS = (("gcn-cora", "ogb_products", 3), ("graphcast", "minibatch_lg", 2),
             ("schnet", "molecule", 2), ("mace", "molecule", 2))
#: a model through the kernel against the same model through the plain
#: segment sum on the card (float32; only the sums' order differs): the
#: loss within this of itself, the outputs within this of their max|.|
GNN_RTOL = 1e-5
#: the lm_train phase: h2o-danube-1.8b's train_4k step at full depth, cut
#: from repro's 16 microbatches of 16 x 4,096 tokens to H2O_ACCUM
#: microbatches of H2O_UB sequences (16,384 tokens a step): H2O_STEPS AdamW
#: steps, then one with the int8 error-feedback compressor
H2O_UB, H2O_ACCUM, H2O_STEPS = 2, 2, 2
#: qwen3-moe's cost1 train steps (the last timed: the first pays first-use
#: costs) on one sequence of 4,096 tokens (repro: 16)
MOE_TRAIN_UB, MOE_TRAIN_STEPS = 1, 2
#: greedy decode steps of qwen3-moe's cost1 decode_32k (batch 128)
MOE_DECODE_STEPS = 4
#: the cost1 prefills through flash_attention at D = 128: (arch, GQA group)
LARGE_PREFILLS = (("qwen3-moe-235b-a22b", 16), ("arctic-480b", 7), ("qwen2-72b", 8),
                  ("mistral-large-123b", 12))
#: two-tower train_batch at FULL width: both vocabularies cut from 10M rows
#: (tables, their dense grads and float32 moments alone would take 81.9 GB)
#: and the batch from 65,536 (its [B, B] logits and their grad 34 GB)
TT_ROWS, TT_BATCH, TT_STEPS = 5_000_000, 16_384, 2
#: the model_shard phase: a (2, 2) ("data", "model") DeviceMesh of 4 ranks,
#: all on the one card over gloo, and their deadline; its cells (gcn-cora x
#: ogb_products, two-tower train_batch, h2o-danube-1.8b train_4k and
#: prefill_32k at cost2)
SHARD_MESH, SHARD_AXES, SHARD_TIMEOUT_S = (2, 2), ("data", "model"), 600
SHARD_CELLS = ("gcn", "two_tower", "train", "prefill", "decode", "sampled")
#: the decode cell (h2o-danube-1.8b decode_32k cost2, batch 128 against the
#: 4,096-slot ring, 2,048 slots a "model" rank): a warm-up step and the
#: first timed step at position 32,768 (the ring full and wrapped: slot 0),
#: the second at 1,500 (the live prefix ends inside model rank 0's slice)
SHARD_DECODE_POSITIONS = (32_768, 1_500)
#: two-tower's vocabularies in the model_shard phase, cut from lm_train's
#: 5M rows because the 4 ranks share one 80 GB card: at 5M a rank holds
#: 20.5 GB (its table shards, their float32 moments and dense grads), 82 GB
#: for the four; at 3M the step's peak (18.6 GB a rank: the grads'
#: all-reduce and the norm's temporaries) ran out of memory once; 2M rows
SHARD_TT_ROWS = 2_000_000
#: two-tower's tables in the model_shard phase are drawn in blocks of this
#: many rows, each block from a generator of its own seed, so that a rank
#: draws only its own rows and the unsharded run the same values
TT_DRAW_ROWS = 1 << 18
#: the float32 train cells, held against the unsharded run's: the first
#: step's grads and the parameters after the two steps.  The sharded step
#: sums in other orders (each rank's rows, then a reduction).  On the card
#: (gcn / two-tower): the grads' RMS distance read 8.82e-6 / 7.52e-4 of
#: their RMS (two-tower's L2 norms and 1/0.05 temperature), 7.49e-3 /
#: 1.15e-3 of the grad elements and 5.76e-4 / 2.16e-5 of the parameters
#: fell beyond ROADMAP.md §3's elementwise rtol 1e-4 / rtol 1e-5, atol 1e-6
#: (Adam divides each grad by its own size, so a grad near 0 carries the
#: sums' order at lr scale), and the parameters' RMS distance read 1.20e-3
#: / 4.12e-3 of their RMS change in the steps.  Each limit is about four
#: times its cell's reading.  A wrong placement moves the grads O(1) (the
#: table grad fault of ROADMAP.md §3: 13.7 of 15.6)
SHARD_F32_LIMITS = {
    "gcn": {"grad_rms": 4e-5, "grad_share": 3e-2, "param_share": 2.5e-3, "param_step": 5e-3},
    "two_tower": {"grad_rms": 3e-3, "grad_share": 5e-3, "param_share": 1e-4,
                  "param_step": 1.6e-2},
}
#: the sampled cell (gcn-cora minibatch_lg, float32) is held to gcn's limits
SHARD_F32_LIMITS["sampled"] = SHARD_F32_LIMITS["gcn"]
#: the bfloat16 train cell: each leaf's RMS distance from the unsharded run
#: at most this share of its RMS change over the two steps
SHARD_BF16_STEP_RATIO = 0.25
#: the production-mesh dry run whose roofline rows the phase prints
SHARD_ROOFLINE = (("h2o-danube-1.8b", "train_4k", ("cost2", "cost4", "opt1", "opt2")),
                  ("mace", "ogb_products", ("chunk2", "chunk4")),
                  ("h2o-danube-1.8b", "decode_32k", ("cost2", "cost4")),
                  ("gcn-cora", "minibatch_lg", ("full",)))
#: sampled table-grad rows held against the plain bag's step
TT_GRAD_ROWS = 256
#: a train step through the bag kernel against the same through the plain
#: bag on the card: the loss, and each grad sample within this of its max
TT_RTOL = 1e-5


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance of two bfloat16 tensors in units in the last place."""
    def key(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits + 32768), bits)
    return (key(a) - key(b)).abs()


def flash_sass(lib_path: str, nvcc: str) -> dict:
    """Tensor-core (HGMMA, HMMA) and TMA (UTMALDG) instructions in the
    built library's SASS, in flash_attention's tensor-core kernel at D = 80
    (``tc80``) and in its FMA kernels at every head dim (``fma``)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    ops = ("HGMMA", "HMMA", "UTMALDG")
    counts = {"tc80": dict.fromkeys(ops, 0), "fma": dict.fromkeys(ops, 0)}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = ("tc80" if "flash_attention_tcILi80E" in line
                  else "fma" if "flash_attention_kernel" in line else None)
        elif fn:
            for op in ops:
                counts[fn][op] += f" {op}" in line
    return counts


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def sync_now() -> float:
    """Host clock once the device has finished all queued work, so a timed
    call never waits for an earlier (warm-up) call's kernels."""
    torch.cuda.synchronize()
    return time.perf_counter()


def sync_s(t0: float) -> float:
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def expect_launches(name: str, n: int, phase: str) -> None:
    """The wrapper's count, zeroed by ``counted`` on entry, is ``n``."""
    from repro_torch.kernels import KERNELS

    if KERNELS[name].launches != n:
        raise AssertionError(
            f"{phase}: {name} launched {KERNELS[name].launches} times, expected {n}")


def checksum(t: torch.Tensor) -> int:
    """Position-weighted sum of a 4-byte buffer's bit patterns."""
    bits = t.view(torch.int32).to(torch.int64)
    pos = torch.arange(bits.shape[0], device=t.device) % 65521 + 1
    return int((bits * pos).sum())


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def tile_bases_row(sw_kernel, incl: torch.Tensor) -> dict:
    """The tile_bases kernel on an inclusive plane ``incl`` [B, T·128]:
    held against float64 cumsum of the tile totals, shifted to exclusive
    (rtol 1e-9), a second call bit for bit; timed beside its plain version
    (the compensated Hillis-Steele scan and the shift) and torch.cumsum in
    float64 of the strided totals.  Bytes: one 32-byte sector a total read,
    bh and bl written."""
    eb = sw_kernel.EB
    b, t = incl.shape[0], incl.shape[1] // eb
    bh, bl = sw_kernel.tile_bases(incl)
    ref = torch.cumsum(incl[:, eb - 1::eb], dim=1, dtype=torch.float64)
    ref = torch.cat([ref.new_zeros(b, 1), ref[:, :-1]], dim=1)
    err = (bh.double() + bl.double() - ref).abs()
    if not bool((err <= 1e-9 * ref.abs()).all()):
        raise AssertionError("tile_bases: the bases disagree with float64 cumsum")
    again = sw_kernel.tile_bases(incl)
    if not (torch.equal(again[0], bh) and torch.equal(again[1], bl)):
        raise AssertionError("tile_bases: a second call gave other bits")
    nz = ref != 0
    max_abs, max_rel = float(err.max()), float((err[nz] / ref[nz]).max())
    del bh, bl, ref, err, again, nz
    return dict(
        name="tile_bases", source="src/repro_torch/csrc/tile_bases.cu",
        replaces="none (repro scans the tile totals with jax.lax.associative_scan)",
        shape=f"[{b},{t}x{eb}] f32 -> 2x[{b},{t}] f32",
        max_abs_err=max_abs, max_rel_err=max_rel,
        tolerance="rtol 1e-9 against float64 cumsum, bit-exact on repeat",
        ms=time_ms(lambda: sw_kernel.tile_bases(incl)),
        plain_ms=time_ms(lambda: sw_kernel.tile_bases_torch(incl), reps=3),
        library_ms=time_ms(
            lambda: torch.cumsum(incl[:, eb - 1::eb], dim=1, dtype=torch.float64), reps=10),
        bytes=b * t * (32 + 8), ops=b * t,
    )


def slot_gather_row(sw_kernel, visits: torch.Tensor, gidx: torch.Tensor, note: str) -> dict:
    """The slot_gather kernel on ``visits`` [B, n] and a walk image's index
    ``gidx`` [T, 128]: bit for bit against its plain version (cat with the
    zero column, index_select) and on a second call; timed beside the plain
    version and index_select alone on visits that already have the zero
    column.  Bytes: the plane written, the index and the visits read once."""
    b, n = visits.shape
    got = sw_kernel.slot_gather(visits, gidx)
    if not torch.equal(got.view(torch.int32),
                       sw_kernel.slot_gather_torch(visits, gidx).view(torch.int32)):
        raise AssertionError(f"slot_gather: the {note} plane differs from the plain version")
    if not torch.equal(sw_kernel.slot_gather(visits, gidx).view(torch.int32),
                       got.view(torch.int32)):
        raise AssertionError(f"slot_gather: a second {note} call gave other bits")
    del got
    zv = torch.cat([visits, visits.new_zeros(b, 1)], dim=1)
    flat = gidx.reshape(-1)
    row = dict(
        name="slot_gather", source="src/repro_torch/csrc/slot_gather.cu",
        replaces="none (repro gathers with jnp.concatenate and fancy indexing)",
        shape=f"{note}: [{b},{n}] f32 at [{gidx.shape[0]},128] i32 -> [{b},{flat.numel()}] f32 "
              f"({sw_kernel.gather_rows_per_pass(b)} rows a pass)",
        max_abs_err=0.0, tolerance="bit-exact, and on repeat",
        ms=time_ms(lambda: sw_kernel.slot_gather(visits, gidx), reps=10),
        plain_ms=time_ms(lambda: sw_kernel.slot_gather_torch(visits, gidx), reps=5),
        library_ms=time_ms(lambda: zv.index_select(1, flat), reps=5),
        bytes=4 * (b * flat.numel() + flat.numel() + b * n), ops=b * flat.numel(),
    )
    del zv
    return row


def time_fresh_ms(make, fn, reps: int = 20) -> float:
    """Mean device time of ``fn(make())`` over ``reps`` calls after a
    warm-up, for a ``fn`` that writes its operands: each call gets fresh
    ones from ``make``, made before its timed span."""
    fn(make())
    spans = []
    for _ in range(reps):
        args = make()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(args)
        end.record()
        spans.append((start, end))
        del args
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / reps


def assert_same_state(a, b, what: str) -> None:
    ta, tb = a.state_tree(), b.state_tree()
    for key in ta:
        if not np.array_equal(ta[key], tb[key]):
            raise AssertionError(f"{what}: state_tree[{key!r}] differs")


@contextlib.contextmanager
def timed_calls(module, name: str):
    """CUDA-event and host time of every call to ``module.name`` while
    active: a list of (start event, end event, host seconds)."""
    inner = getattr(module, name)
    spans = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        spans.append((start, end, time.perf_counter() - t0))
        return out

    setattr(module, name, timed)
    try:
        yield spans
    finally:
        setattr(module, name, inner)


@contextlib.contextmanager
def count_calls(module, names):
    """Count the calls made to each ``module.<name>`` while active."""
    calls = dict.fromkeys(names, 0)
    inner = {name: getattr(module, name) for name in names}

    def spy(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return inner[name](*args, **kwargs)
        return call

    for name in names:
        setattr(module, name, spy(name))
    try:
        yield calls
    finally:
        for name in names:
            setattr(module, name, inner[name])


@contextlib.contextmanager
def load_split(csr):
    """Split the ``csr.from_coo`` calls made while active: its host time,
    the host conversions (host clock), the host->device copies and the
    device build (CUDA events), summed over the calls, in a dict filled on
    exit (after the caller's device synchronise)."""
    parts = {}
    with timed_calls(csr, "from_coo") as fc, timed_calls(csr, "_coo_int32") as cv, \
            timed_calls(csr, "_to_device") as cp, timed_calls(csr, "_build_device") as bd:
        yield parts
    torch.cuda.synchronize()
    parts["from_coo_host_ms"] = sum(h_ for _, _, h_ in fc) * 1e3
    parts["host_conversions_ms"] = sum(h_ for _, _, h_ in cv) * 1e3
    parts["copies_event_ms"] = sum(a_.elapsed_time(b_) for a_, b_, _ in cp)
    parts["device_build_event_ms"] = sum(a_.elapsed_time(b_) for a_, b_, _ in bd)


@contextlib.contextmanager
def counted(kernels: dict, launches: dict):
    """Count the kernel launches of one main-path call: every wrapper's
    count is set to 0 on entry and added to ``launches`` on exit."""
    for k in kernels.values():
        k.launches = 0
    yield
    for name, k in kernels.items():
        launches[name] += k.launches


@contextlib.contextmanager
def largest_call(module, name: str, size, keep=lambda args, kwargs: (args, kwargs)):
    """Keep ``keep(args, kwargs)`` of the largest call (by ``size(args)``)
    made to ``module.name`` while active, taken before the call (which goes
    through unchanged) under ``seen["args"]`` and ``seen["kwargs"]``."""
    inner = getattr(module, name)
    seen = {}

    def spy(*args, **kwargs):
        if not seen or size(args) > seen["size"]:
            seen["size"] = size(args)
            seen["args"], seen["kwargs"] = keep(args, kwargs)
        return inner(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, inner)


def image_live(img):
    """(degrees, live dst, live weights) of a walk image's rows, in row
    order, on its device: what any layout of the same graph must hold."""
    dev = img.dst.device
    nv = img.nv
    degs = torch.from_numpy(img.degs[:nv].copy()).to(dev)
    starts = torch.from_numpy(np.maximum(img.starts[:nv], 0)).to(dev)
    m = int(img.degs[:nv].sum())
    shift = torch.repeat_interleave(starts - (torch.cumsum(degs, 0) - degs), degs, output_size=m)
    gidx = shift + torch.arange(m, device=dev)
    return degs, img.dst[gidx], img.wgt[gidx]


def rebuild_rule(img, plan, alloc) -> str | None:
    """The rebuild rule of ``repro``'s walk image that the next flush of
    ``plan`` meets, or None when it patches (the rules of
    ``WalkImage._plan_patch`` and ``queue``, checked without mutating)."""
    if img is None:
        return "no cached image"
    if img._stale:
        return "stale image (MAX_PENDING overflow or compaction)"
    if plan.max_insert_vertex() >= img.nv:
        return "vertex growth"
    _, rows, deg_old, ins = plan.active_rows(img.degs, img.nv)
    ub = deg_old + ins
    grow = ub > img.caps[rows]
    if img.bump + int(alloc.edge_capacities(ub[grow]).sum()) > img.cap_e:
        return "bump slack exhausted"
    return None


def twin_image(img):
    """A private copy of a walk image and its queued plans."""
    return dataclasses.replace(
        img, dst=img.dst.clone(), wgt=img.wgt.clone(), rows=img.rows.clone(),
        starts=img.starts.copy(), caps=img.caps.copy(), degs=img.degs.copy(),
        _pending=list(img._pending), _blocks=None, _cow=False)


def stream_phase(c, g, plans, vk, launches: dict, times: dict, dev) -> None:
    """The stream phase: paper tasks 1-4 on SortedCOO, LazyCSR, ChunkedGraph
    and Vector2D, one at a time (see the module docstring).  ``c`` is the
    CSR the DiGraph ``g`` was loaded from, ``plans`` the update phase's
    (name, plan) batches, ``vk`` the DiGraph's normalised walk after them;
    kernel launches add into ``launches``, times into ``times``."""
    from repro_torch.core import REPRESENTATIONS, alloc, walk_image
    from repro_torch.core import chunked as chunked_mod
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.slot_update import kernel as su_kernel
    from repro_torch.kernels.slot_update import ops as su_ops
    from repro_torch.kernels.slot_walk import kernel as sw_kernel
    from repro_torch.kernels.slot_walk import ops as sw_ops

    ref = g.to_csr()
    plain_merge = ("gather_merge_torch", "merge_rows_fused_torch")

    def merge_shape(args):  # ChunkedGraph's row merge: (A, K, W) of its [A, K, W] tensor
        return args[0].shape[0], args[2].shape[1], args[0].shape[1]
    for rep in ("coo", "lazy", "chunked", "vector2d"):
        cls = REPRESENTATIONS[rep]
        r0 = t0 = sync_now()
        with counted(KERNELS, launches):
            r = cls.from_csr(c, device=dev)
        times[f"{rep}_load_ms"] = sync_s(t0) * 1e3
        t0 = sync_now()
        with counted(KERNELS, launches):
            cl = r.clone()
        times[f"{rep}_clone_ms"] = sync_s(t0) * 1e3
        a_, b_ = cl.to_csr(), r.to_csr()
        for f in ("offsets", "dst", "wgt"):
            if not torch.equal(getattr(a_, f), getattr(b_, f)):
                raise AssertionError(f"stream/{rep}: clone {f} differs")
        del cl, a_, b_
        t0 = sync_now()
        gen = walk_image.seal_generation(r, 0)  # builds the image, then seals it
        build_ms = sync_s(t0) * 1e3
        sums = {f: checksum(getattr(gen, f)) for f in ("dst", "wgt", "rows")}
        with counted(KERNELS, launches):
            r.reverse_walk(WALK_STEPS)
        stats = dict.fromkeys(walk_image.STATS, 0)
        rep_launches = dict.fromkeys(KERNELS, 0)
        rules, wsplit, twin_note, eq_shape = [], {}, "no twin", (0, 0, 0)
        for bname, plan in plans:
            spy = (largest_call(chunked_mod, "_apply_rows", lambda a_: np.prod(merge_shape(a_)),
                                lambda a_, k_: (merge_shape(a_), {}))
                   if rep == "chunked" else contextlib.nullcontext({}))
            t0 = sync_now()
            with counted(KERNELS, launches), spy as seen:
                r, _ = r.apply(plan)
            times[f"{rep}_{bname}_ms"] = sync_s(t0) * 1e3
            if seen and np.prod(seen["args"]) > np.prod(eq_shape):
                eq_shape = seen["args"]
            rimg = r._image
            rule = rebuild_rule(rimg, plan, alloc)
            twin = twin_image(rimg) if bname == "mixed" and rule is None else None
            before, stats0 = dict(rep_launches), walk_image.stats_snapshot()
            t0 = sync_now()
            with counted(KERNELS, rep_launches), count_calls(su_kernel, plain_merge) as pm, \
                    count_calls(sw_kernel, ("tile_cumsum_torch", "slot_gather_torch")) as pc, \
                    timed_calls(su_ops, "fused_apply") as fa, \
                    timed_calls(sw_ops, "slot_walk_multi_blocked") as ws:
                r.reverse_walk(WALK_STEPS)
            walk_ms = sync_s(t0) * 1e3
            for k_, v_ in walk_image.stats_snapshot().items():
                stats[k_] += v_ - stats0[k_]
            if any(pm.values()) or any(pc.values()):
                raise AssertionError(f"stream/{rep}/{bname}: plain versions ran: {pm} {pc}")
            steps_run = rep_launches["tile_cumsum"] - before["tile_cumsum"]
            if steps_run != WALK_STEPS:
                raise AssertionError(f"stream/{rep}/{bname}: {steps_run} tile_cumsum launches")
            if rule is None and (len(fa) != 1 or rep_launches["merge_rows_fused"]
                                 == before["merge_rows_fused"]):
                raise AssertionError(f"stream/{rep}/{bname}: the walk did not patch the image")
            if rule is None and r._image._stale:
                rule = "compaction (occupancy under half of the build's)"
            if rule is not None:
                rules.append(f"{bname}: {rule}")
            if bname == "mixed":
                times[f"{rep}_walk_ms"] = walk_ms
                patch_ev = sum(a_.elapsed_time(b_) for a_, b_, _ in fa)
                steps_ev = sum(a_.elapsed_time(b_) for a_, b_, _ in ws)
                wsplit = {"walk_patch_event_ms": patch_ev,
                         "walk_steps_event_ms": steps_ev,
                         "merge_launches": rep_launches["merge_rows_fused"]
                         - before["merge_rows_fused"]}
            if twin is not None:
                # the mixed batch's patch again, on a copy, with the plain
                # versions: the same image bit for bit, the same walk
                twin_launches = dict.fromkeys(KERNELS, 0)
                with counted(KERNELS, twin_launches), count_calls(su_kernel, plain_merge) as pm:
                    vt = twin.walk_flush(WALK_STEPS, backend="torch", normalize=True)
                if vt is None or any(twin_launches.values()) or not any(pm.values()):
                    raise AssertionError(f"stream/{rep}: the plain twin did not patch alone")
                rimg = r._image
                for f in ("dst", "wgt", "rows"):
                    if not torch.equal(getattr(rimg, f).view(torch.int32),
                                       getattr(twin, f).view(torch.int32)):
                        raise AssertionError(f"stream/{rep}: merge_rows_fused {f} differs "
                                             "from the plain twin")
                for f in ("starts", "caps", "degs"):
                    if not np.array_equal(getattr(rimg, f), getattr(twin, f)):
                        raise AssertionError(f"stream/{rep}: patched {f} differs from the twin")
                if (rimg.bump, rimg.live) != (twin.bump, twin.live):
                    raise AssertionError(f"stream/{rep}: bump/live differ from the twin")
                for x_, y_ in zip(rimg.device_blocks(), twin.device_blocks()):
                    if not torch.equal(x_, y_):
                        raise AssertionError(f"stream/{rep}: [lo, hi) differ from the twin")
                vi = rimg.walk(WALK_STEPS, normalize=True, backend="cuda")
                torch.testing.assert_close(vi, vt, rtol=WALK_RTOL, atol=WALK_ATOL)
                twin_note = "bit-identical image, walk rtol 5e-4"
                del twin, vt, vi
        for k_, v_ in rep_launches.items():
            launches[k_] += v_
        if not rules and (stats["builds"] or stats["rebuilds"] or stats["patches"] != 3):
            raise AssertionError(f"stream/{rep}: walks after the first did not all patch: "
                                 f"{stats}")
        out = r.to_csr()
        for f in ("offsets", "dst", "wgt"):
            if not torch.equal(getattr(out, f), getattr(ref, f)):
                raise AssertionError(f"stream/{rep}: to_csr {f} differs from the DiGraph's")
        del out
        vn = r.reverse_walk(WALK_STEPS, normalize=True)
        torch.testing.assert_close(vn, vk, rtol=WALK_RTOL, atol=WALK_ATOL)
        del vn
        rimg, r._image = r._image, None
        fresh = r.to_walk_image()  # a fresh build of the same representation
        r._image = rimg
        for x_, y_ in zip(image_live(rimg), image_live(fresh)):
            if not torch.equal(x_.view(torch.int32), y_.view(torch.int32)):
                raise AssertionError(f"stream/{rep}: patched image rows differ from a fresh build")
        del fresh
        audit = rimg.audit()
        for f, s_ in sums.items():
            if checksum(getattr(gen, f)) != s_:
                raise AssertionError(f"stream/{rep}: sealed generation buffer {f} changed")
        say("stream", rep=rep, rep_s=f"{time.perf_counter() - r0:.1f}", m=r.m, nv=rimg.nv,
            cap_e=rimg.cap_e, bump=rimg.bump, occupancy=f"{rimg.occupancy:.4f}", load_ms=f"{times[f'{rep}_load_ms']:.1f}",
            clone_ms=f"{times[f'{rep}_clone_ms']:.2f}", seal_build_ms=f"{build_ms:.1f}",
            **{f"{b_}_ms": f"{times[f'{rep}_{b_}_ms']:.1f}" for b_, _ in plans},
            walk_ms=f"{times[f'{rep}_walk_ms']:.1f}",
            **{k_: (v_ if isinstance(v_, int) else f"{v_:.4f}") for k_, v_ in wsplit.items()},
            merge_launches_total=rep_launches["merge_rows_fused"],
            tile_cumsum_launches=rep_launches["tile_cumsum"], plain_calls=0,
            stats="+".join(f"{k_}{v_}" for k_, v_ in stats.items()),
            rebuild_rules="; ".join(rules) or "none fired", to_csr="bit-identical to DiGraph",
            walk_vs_digraph="normalised, rtol 5e-4", fresh_image="live rows bit-identical",
            twin=twin_note, audit=f"passed ({audit['blocks']} blocks)", generation="unchanged",
            **({"largest_row_merge": "x".join(map(str, eq_shape)), "its_passes": -(
                -eq_shape[0] // max(chunked_mod.EQ_ELEMS_MAX // (eq_shape[1] * eq_shape[2]), 1))}
               if rep == "chunked" else {}))
        del r, gen, rimg
        torch.cuda.empty_cache()


def same_bits(a, b) -> bool:
    """Two numpy arrays or tensors of one dtype and shape, bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def assert_same_rep(a, b, what: str) -> None:
    """``to_csr()`` (first: it consolidates a LazyCSR on both sides) and
    every ``state_tree()`` array of two representations, bit for bit."""
    ca, cb = a.to_csr(), b.to_csr()
    for f in ("offsets", "dst", "wgt"):
        if not same_bits(getattr(ca, f), getattr(cb, f)):
            raise AssertionError(f"{what}: to_csr {f} differs")
    ta, tb = a.state_tree(), b.state_tree()
    if ta.keys() != tb.keys():
        raise AssertionError(f"{what}: state_tree keys differ")
    for key in ta:
        if not same_bits(ta[key], tb[key]):
            raise AssertionError(f"{what}: state_tree[{key!r}] differs")


def crash_at(faultinject, point: str, call) -> None:
    """Run ``call`` with the fault point ``point`` armed: it must raise
    ``SimulatedCrash`` there, which is caught here and nothing else."""
    faultinject.arm(point)
    try:
        call()
    except faultinject.SimulatedCrash:
        return
    finally:
        faultinject.disarm()
    raise AssertionError(f"durable: {point} was armed but did not crash")


def host_split(what: str, total_ms: float, call, crcs) -> dict:
    """A checkpoint's time split by the spans of its manager call and of
    the CRC passes inside it (host clock): the state_tree copies before the
    call, the CRCs, and the rest of the call (npz write, chunk packing)."""
    call_ms = sum(h_ for _, _, h_ in call) * 1e3
    crc_ms = sum(h_ for _, _, h_ in crcs) * 1e3
    return {f"{what}_state_tree_ms": total_ms - call_ms, f"{what}_crc_ms": crc_ms,
            f"{what}_write_ms": call_ms - crc_ms}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def durable_phase(c, launches: dict, times: dict, dev, card: str) -> None:
    """The durable phase (see the module docstring).  ``c`` is the social
    CSR on the card; kernel launches add into ``launches``, times into
    ``times``.  The journal and checkpoints live under
    ``build/chip_smoke_durable_<pid>/``, removed on the way out whether
    the checks pass or not."""
    from repro_torch.core import REPRESENTATIONS, DiGraph, edgebatch, updates
    from repro_torch.io import synthetic
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.slot_update import kernel as su_kernel
    from repro_torch.kernels.slot_walk import kernel as sw_kernel
    from repro_torch.runtime import durable, faultinject

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"chip_smoke_durable_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    wal, ck = os.path.join(root, "wal"), os.path.join(root, "ckpt")
    plain_merge = ("gather_merge_torch", "merge_rows_fused_torch")
    p0 = time.perf_counter()

    def draw(csr_, rounds):
        """bench_recovery's ``_batches``: each round, half = 1e-2 |E| // 2
        random insertions, then as many random deletions of live edges."""
        rng = np.random.default_rng(11)
        half = max(int(csr_.m * 1e-2) // 2, 1)
        return [updates.plan_update(inserts=edgebatch.random_insertions(rng, csr_.n, half),
                                    deletes=edgebatch.random_deletions(rng, csr_, half))
                for _ in range(rounds)]

    try:
        with count_calls(DiGraph, ("compact",)) as compactions:
            # 1. load and wrap (an uncrashed twin from the same CSR)
            t0 = sync_now()
            with counted(KERNELS, launches):
                g0 = DiGraph.from_csr(c, device=dev)
            load_ms = sync_s(t0) * 1e3
            twin = DiGraph.from_csr(c, device=dev)
            t0 = time.perf_counter()
            plans = draw(c, 8)
            draw_s = time.perf_counter() - t0
            mgr = durable.ckpt
            t0 = sync_now()
            with timed_calls(mgr, "save_arrays_sharded") as sv, \
                    timed_calls(mgr, "_chunk_crcs") as cc:
                dg = durable.DurableGraph(g0, wal, ck, diff=True, keep=2)
            times["ckpt_full_ms"] = sync_s(t0) * 1e3
            split = host_split("ckpt_full", times["ckpt_full_ms"], sv, cc)
            full_bytes = dir_bytes(ck)
            peak = dir_bytes(root)

            # 2. rounds 1-4 through apply, then a differential checkpoint
            apply_s, append_s = [], []
            with timed_calls(durable.UpdateJournal, "_write_flush") as wf:
                for plan in plans[:4]:
                    with timed_calls(durable.UpdateJournal, "append") as ap:
                        t0 = sync_now()
                        with counted(KERNELS, launches):
                            dg.apply(plan)
                        apply_s.append(sync_s(t0))
                    append_s.append(ap[0][2])
                    twin.apply(plan)
                t0 = sync_now()
                with timed_calls(mgr, "save_arrays_diff") as sv, \
                        timed_calls(mgr, "_chunk_crcs") as cc:
                    path = dg.checkpoint()
                times["ckpt_diff_ms"] = sync_s(t0) * 1e3
                split.update(host_split("ckpt_diff", times["ckpt_diff_ms"], sv, cc))
                with open(os.path.join(path, "manifest.json")) as f:
                    man = json.load(f)
                if man["kind"] != "diff" or man["base_step"] != 0:
                    raise AssertionError(f"durable: step 4 is {man['kind']}, not a diff on step 0")
                crcs = man["shards"]["0"]["chunks"]
                with np.load(os.path.join(path, "shard_0.npz")) as npz:
                    persisted = sum(npz[k].shape[0] if k.endswith("::idx") else len(crcs[k])
                                    for k in npz.files if not k.endswith("::dat"))
                chunks = sum(len(v_) for v_ in crcs.values())
                diff_bytes = dir_bytes(path)
                peak = max(peak, dir_bytes(root))

                # 3. rounds 5-6 in one group commit, round 7 crashed
                flushes = dg.journal.flushes
                with counted(KERNELS, launches):
                    dg.apply_group(plans[4:6])
                if dg.journal.flushes != flushes + 1:
                    raise AssertionError("durable: the group commit flushed "
                                         f"{dg.journal.flushes - flushes} times")
                crash_at(faultinject, "durable.post_append", lambda: dg.apply(plans[6]))
                records_written = 7
            times["wal_append_ms"] = sum(h_ for _, _, h_ in wf) * 1e3 / records_written
            for plan in plans[4:7]:
                twin.apply(plan)
            peak = max(peak, dir_bytes(root))
            dg.close()
            del dg, g0
            torch.cuda.empty_cache()

            # 4. recover on the card (the audit timed alone)
            st, rec_launches = {}, dict.fromkeys(KERNELS, 0)
            with counted(KERNELS, rec_launches), count_calls(su_kernel, plain_merge) as pm, \
                    timed_calls(mgr, "restore_arrays_diff") as rd, \
                    timed_calls(mgr, "restore_arrays_sharded") as rb, \
                    timed_calls(mgr, "_chunk_crcs") as cc, timed_calls(mgr, "_patch_chunks") as pt:
                r = durable.DurableGraph.recover(wal, ck, device=dev, audit=False, stats=st,
                                                 diff=True, keep=2)
            torch.cuda.synchronize()
            times["restore_ms"] = st["restore_s"] * 1e3
            times["replay_ms"] = st["replay_s"] * 1e3
            host_ms = lambda spans: sum(h_ for _, _, h_ in spans) * 1e3  # noqa: E731
            split.update(restore_base_load_ms=host_ms(rb), restore_crc_gate_ms=host_ms(cc),
                         restore_patch_ms=host_ms(pt),
                         restore_to_device_ms=times["restore_ms"] - host_ms(rd))
            t0 = sync_now()
            audit = faultinject.audit(r.rep)
            times["audit_ms"] = sync_s(t0) * 1e3
            times["recover_ms"] = times["restore_ms"] + times["replay_ms"] + times["audit_ms"]
            if st["records"] != 3 or r.seq != 7:
                raise AssertionError(f"durable: replayed {st['records']} records to seq {r.seq}")
            if rec_launches["merge_rows_fused"] == 0 or any(pm.values()):
                raise AssertionError(f"durable: the replay launched merge_rows_fused "
                                     f"{rec_launches['merge_rows_fused']} times, plain {pm}")

            # 5. the recovered graph against the uncrashed twin
            assert_same_rep(r.rep, twin, "durable/recovered")
            walk_launches = dict.fromkeys(KERNELS, 0)
            with counted(KERNELS, walk_launches), \
                    count_calls(sw_kernel, ("tile_cumsum_torch", "slot_gather_torch")) as pc:
                vr = r.reverse_walk(WALK_STEPS)
            vt = twin.reverse_walk(WALK_STEPS)
            if not same_bits(vr, vt):
                raise AssertionError("durable: the recovered walk differs from the twin's")
            if walk_launches["tile_cumsum"] != WALK_STEPS or any(pc.values()):
                raise AssertionError(f"durable: the walk launched tile_cumsum "
                                     f"{walk_launches['tile_cumsum']} times, plain {pc}")
            del vr, vt
            with counted(KERNELS, launches):
                r.apply(plans[7])
            twin.apply(plans[7])
            assert_same_rep(r.rep, twin, "durable/round 8")
            for src_ in (rec_launches, walk_launches):
                for k_, v_ in src_.items():
                    launches[k_] += v_
            ops = sum(p_.n_ops for p_ in plans[4:7])
            share = sum(append_s) / sum(apply_s)
            r.close()
            del r, twin
            torch.cuda.empty_cache()
            say("durable", card=card, rep="digraph", n=c.n, m=c.m, rounds=8,
                ops_per_round=plans[0].n_ops, draw_s=f"{draw_s:.1f}",
                load_ms=f"{load_ms:.1f}",
                ckpt_full_ms=f"{times['ckpt_full_ms']:.1f}", ckpt_full_bytes=full_bytes,
                ckpt_diff_ms=f"{times['ckpt_diff_ms']:.1f}", ckpt_diff_bytes=diff_bytes,
                **{k_: f"{v_:.1f}" for k_, v_ in split.items()},
                diff_chunks_persisted=f"{persisted}/{chunks}",
                diff_persisted_share=f"{persisted / chunks:.4f}",
                apply_ms="/".join(f"{x_ * 1e3:.1f}" for x_ in apply_s),
                append_ms="/".join(f"{x_ * 1e3:.1f}" for x_ in append_s),
                append_share=f"{share:.4f}", wal_append_ms=f"{times['wal_append_ms']:.3f}",
                group_flushes=1, crash="durable.post_append at round 7",
                records=st["records"], restore_ms=f"{times['restore_ms']:.1f}",
                replay_ms=f"{times['replay_ms']:.1f}",
                replayed_ops_per_s=f"{ops / st['replay_s']:.0f}",
                audit_ms=f"{times['audit_ms']:.1f}", audit_blocks=audit["blocks"],
                recover_ms=f"{times['recover_ms']:.1f}",
                replay_merge_launches=rec_launches["merge_rows_fused"],
                walk_tile_cumsum_launches=walk_launches["tile_cumsum"], plain_calls=0,
                state_tree="every slot bit-identical to the twin", to_csr="bit-identical",
                walk="42 steps bit-identical", round_8="bit-identical",
                peak_bytes=peak)

            # 6. the other four representations at scale 16
            c16 = synthetic.make_graph("social", scale=16, edge_factor=EDGE_FACTOR, seed=SEED,
                                       device=dev)
            plans16 = draw(c16, 4)
            for name in ("coo", "lazy", "chunked", "vector2d"):
                cls = REPRESENTATIONS[name]
                d_ = os.path.join(root, name)
                tw = cls.from_csr(c16, device=dev)
                tw.reverse_walk(1)  # the twin's image, patched by every later walk
                with counted(KERNELS, launches):
                    dgx = durable.DurableGraph(cls.from_csr(c16, device=dev),
                                               os.path.join(d_, "wal"), os.path.join(d_, "ckpt"))
                    for plan in plans16[:3]:
                        dgx.apply(plan)
                for plan in plans16:
                    tw, _ = tw.apply(plan)
                    tw.reverse_walk(1)
                with counted(KERNELS, launches):
                    crash_at(faultinject, "durable.post_apply", lambda: dgx.apply(plans16[3]))
                dgx.close()
                del dgx
                st = {}
                t0 = sync_now()
                with counted(KERNELS, launches):
                    rx = durable.DurableGraph.recover(os.path.join(d_, "wal"),
                                                      os.path.join(d_, "ckpt"),
                                                      device=dev, stats=st)
                rec_ms = sync_s(t0) * 1e3
                if st["records"] != 4:
                    raise AssertionError(f"durable/{name}: replayed {st['records']} records")
                assert_same_rep(rx.rep, tw, f"durable/{name}")
                with counted(KERNELS, launches):
                    vx = rx.reverse_walk(WALK_STEPS, normalize=True)
                torch.testing.assert_close(vx, tw.reverse_walk(WALK_STEPS, normalize=True),
                                           rtol=WALK_RTOL, atol=WALK_ATOL)
                peak = max(peak, dir_bytes(root))
                rx.close()
                say("durable", card=card, rep=name, scale=16, n=c16.n, m=c16.m,
                    crash="durable.post_apply at plan 4", records=st["records"],
                    recover_ms=f"{rec_ms:.1f}", restore_ms=f"{st['restore_s'] * 1e3:.1f}",
                    replay_ms=f"{st['replay_s'] * 1e3:.1f}",
                    to_csr_and_state_tree="bit-identical to the card twin",
                    walk="normalised, rtol 5e-4 (rebuilt vs patched image)")
                del rx, tw, vx
            del c16
            torch.cuda.empty_cache()
        say("durable", card=card, digraph_compactions=compactions["compact"],
            peak_bytes=peak, phase_s=f"{time.perf_counter() - p0:.1f}")
    finally:
        faultinject.disarm()
        shutil.rmtree(root, ignore_errors=True)


def hold_walk(got, ref, hub, what: str) -> dict:
    """Hold a walk against a reference walk of the same graph: each row
    within rtol 1e-4 of the reference (5e-4 on ``hub`` rows, the
    uncompensated intra-tile level's band) plus 1e-6 of its walk's largest
    visit (the ~ulp residue a tile prefix leaves on a row whose sum is 0
    or small, in another tile alignment).  -> the max relative diffs."""
    ref64, got64 = ref.double(), got.double()
    err = (got64 - ref64).abs()
    rtol = torch.where(hub, WALK_RTOL, EXACT_WALK_RTOL)
    bad = err > rtol * ref64.abs() + WALK_ATOL * ref64.abs().amax(dim=-1, keepdim=True)
    if tuple(got.shape) != tuple(ref.shape) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or non-finite visits")
    if bool(bad.any()):
        idx = torch.nonzero(bad)[:4].tolist()
        raise AssertionError(f"{what}: {int(bad.sum())} visits beyond tolerance, e.g. "
                             + ", ".join(f"{i}: {float(got64[tuple(i)])} vs "
                                         f"{float(ref64[tuple(i)])}" for i in idx))
    nz = ref64 != 0
    rel = torch.where(nz, err / ref64.abs().clamp(min=1e-300), torch.zeros_like(err))
    return {"max_rel_diff": float(rel[~hub.expand_as(rel)].max()),
            "max_rel_diff_hub": float(rel[hub.expand_as(rel)].max()) if bool(hub.any()) else 0.0}


def device_profile(fn) -> tuple:
    """(device ms of the kernels ``fn()`` ran, their launches), from one
    ``torch.profiler`` trace of the call."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU]
    us = 0.0
    for e in kernels:
        t_ = getattr(e, "device_time_total", None)
        us += e.cuda_time_total if t_ is None else t_
    return us / 1e3, sum(e.count for e in kernels)


def twin_sharded(sg, dist):
    """A private copy of a sharded graph (every shard's payload and
    geometry), healthy, on its device."""
    return dist.ShardedGraph(shards=[twin_image(img) for img in sg.shards], n=sg.n,
                             rows_max=sg.rows_max, n_shards=sg.n_shards, dense=sg.dense)


def assert_same_sharded(a, b, what: str, dist) -> None:
    """``gather_csr`` and every shard's ``state_trees()`` array of two
    sharded graphs, bit for bit."""
    ca, cb = dist.gather_csr(a), dist.gather_csr(b)
    for f in ("offsets", "dst", "wgt"):
        if not same_bits(getattr(ca, f), getattr(cb, f)):
            raise AssertionError(f"{what}: gather_csr {f} differs")
    ta, tb = a.state_trees(), b.state_trees()
    for s in tb:
        for key in tb[s]:
            if not same_bits(ta[s][key], tb[s][key]):
                raise AssertionError(f"{what}: shard {s} state_trees[{key!r}] differs")


def down_rows_of(g):
    """``count_torn_reads``' ``down_rows_of`` for a sharded graph ``g``: a
    degraded response's down shards' rows (None at full coverage)."""
    rows = {}

    def of(t_):
        if not t_.down_shards:
            return None
        key = tuple(t_.down_shards)
        if key not in rows:
            rows[key] = np.concatenate([np.arange(*g.owned_range(s_)) for s_ in key])
        return rows[key]

    return of


def sharded_phase(c, g, plans, launches: dict, times: dict, dev, card: str) -> None:
    """The sharded phase (see the module docstring).  ``c`` is the social
    CSR on the card, ``g`` the update phase's DiGraph (after ``plans``).
    The journal and checkpoints live under ``build/chip_smoke_sharded_<pid>/``,
    removed on the way out whether the checks pass or not."""
    from repro_torch.core import DiGraph, distributed as dist, edgebatch, updates
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.slot_update import kernel as su_kernel
    from repro_torch.kernels.slot_update import ops as su_ops
    from repro_torch.kernels.slot_walk import kernel as sw_kernel
    from repro_torch.launch import serve as launch_serve
    from repro_torch.runtime import durable, failover, faultinject
    from repro_torch.runtime import serve as serve_mod

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"chip_smoke_sharded_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    wal, ck = os.path.join(root, "wal"), os.path.join(root, "ckpt")
    plain = ("tile_cumsum_torch", "gather_merge_torch", "merge_rows_fused_torch")
    phase = dict.fromkeys(KERNELS, 0)
    p0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    n = int(c.n)
    rng = np.random.default_rng(SEED + 2)

    def draw(csr_):
        """A mixed plan: SHARD_PLAN_FRAC |E| random insertions and as many
        random deletions of live edges."""
        k = max(round(SHARD_PLAN_FRAC * csr_.m), 1)
        return updates.plan_update(inserts=edgebatch.random_insertions(rng, n, k),
                                   deletes=edgebatch.random_deletions(rng, csr_, k))

    def walk_steps(call, want: int, what: str):
        """``call()`` inside ``counted``: tile_cumsum launched ``want`` times."""
        with counted(KERNELS, phase):
            out = call()
        if KERNELS["tile_cumsum"].launches != want:
            raise AssertionError(f"sharded/{what}: tile_cumsum launched "
                                 f"{KERNELS['tile_cumsum'].launches} times, expected {want}")
        return out

    try:
        with count_calls(sw_kernel, plain[:1]) as pc, count_calls(su_kernel, plain[1:]) as pm:
            # 1. build, and the structure back
            t0 = sync_now()
            with counted(KERNELS, phase):
                sg = dist.shard_csr(c, SHARDS, device=dev)
            times["sharded_build_ms"] = sync_s(t0) * 1e3
            shard_bytes = [sum(t_.numel() * t_.element_size() for t_ in (i.dst, i.wgt, i.rows))
                           for i in sg.shards]
            gc = dist.gather_csr(sg)
            for f in ("offsets", "dst", "wgt"):
                if not same_bits(getattr(gc, f), getattr(c, f)[: c.m if f != "offsets" else None]):
                    raise AssertionError(f"sharded: gather_csr {f} differs from the CSR")
            del gc
            say("sharded", card=card, shards=SHARDS, n=n, m=c.m, rows_max=sg.rows_max,
                cap_e=sg.cap_e, dense=sg.dense,
                live="/".join(str(int(i.live)) for i in sg.shards),
                bump="/".join(str(int(i.bump)) for i in sg.shards),
                edges_hi="/".join(str(i.edges_hi()) for i in sg.shards),
                bytes_on_card="/".join(str(b_) for b_ in shard_bytes),
                total_gb=f"{sum(shard_bytes) / 1e9:.3f}",
                build_ms=f"{times['sharded_build_ms']:.1f}", gather_csr="bit-identical")

            # 2. walks against the DiGraph image walk of the same CSR
            img = DiGraph.from_csr(c, device=dev).to_walk_image()
            hub = c.degrees >= HUB_DEGREE
            one = hold_walk(walk_steps(lambda: sg.reverse_walk(4), 4 * SHARDS, "walk"),
                            img.walk(4), hub, "sharded/walk")
            wrng = np.random.default_rng(SERVE_VERIFY_SEED)
            v0 = torch.stack([launch_serve.seed_visits_row(n, wrng.integers(0, n, SERVE_SEEDS),
                                                           device=dev)
                              for _ in range(SERVE_BATCH)])
            b16 = hold_walk(walk_steps(lambda: sg.reverse_walk(4, visits0=v0), 4 * SHARDS,
                                       "walk/B=16"),
                            img.walk(4, visits0=v0), hub, "sharded/walk B=16")
            sg.reverse_walk(1)  # warm-up
            t0 = sync_now()
            v = walk_steps(lambda: sg.reverse_walk(WALK_STEPS), SHARDS * WALK_STEPS, "walk/42")
            times["sharded_walk_ms"] = sync_s(t0) * 1e3
            if tuple(v.shape) != (n,):
                raise AssertionError(f"sharded/walk: shape {tuple(v.shape)} != ({n},)")
            del v
            times["sharded_walk_b16_event_ms"] = time_ms(
                lambda: sg.reverse_walk(4, visits0=v0), reps=5)
            single_b16 = time_ms(lambda: img.walk(4, visits0=v0), reps=5)
            t0 = sync_now()
            img.walk(WALK_STEPS)
            single_ms = sync_s(t0) * 1e3
            busy = {}  # a 4-step walk's wall, its kernels' device time, launches
            for k_, fn in (("sharded", lambda: sg.reverse_walk(4)),
                           ("digraph_image", lambda: img.walk(4))):
                t0 = sync_now()
                fn()
                busy[k_] = (sync_s(t0) * 1e3, *device_profile(fn))
            del img
            torch.cuda.empty_cache()
            say("sharded", card=card, walk_steps=WALK_STEPS,
                walk_ms=f"{times['sharded_walk_ms']:.1f}",
                b16_event_ms=f"{times['sharded_walk_b16_event_ms']:.4f}",
                digraph_image_b16_event_ms=f"{single_b16:.4f}",
                digraph_image_walk_ms=f"{single_ms:.1f}",
                **{f"{k_}_walk4_ms": f"{v_[0]:.2f}" for k_, v_ in busy.items()},
                **{f"{k_}_walk4_device_busy_ms": f"{v_[1]:.2f}" for k_, v_ in busy.items()},
                **{f"{k_}_walk4_kernel_launches": v_[2] for k_, v_ in busy.items()},
                **{f"walk4_{k_}": f"{v_:.3e}" for k_, v_ in one.items()},
                **{f"b16_{k_}": f"{v_:.3e}" for k_, v_ in b16.items()},
                hub_rows=int(hub.sum()), vs_digraph="rtol 1e-4 (hub rows 5e-4) + 1e-6 of max")

            # 3. the update phase's plans, routed
            apply_ms, merge_launches = {}, {}
            for name, plan in plans:
                gen0 = sg.generation
                routed = len(dist.route_updates(plan, SHARDS, sg.rows_max))
                with count_calls(su_ops, ("fused_apply",)) as fa:
                    t0 = sync_now()
                    with counted(KERNELS, phase):
                        sg.apply(plan)
                    apply_ms[name] = sync_s(t0) * 1e3
                merges = KERNELS["merge_rows_fused"].launches
                if sg.generation != gen0 or fa["fused_apply"] != routed or merges < routed:
                    raise AssertionError(f"sharded/{name}: {fa['fused_apply']} patches of "
                                         f"{routed} routed shards, {merges} merges, "
                                         f"generation {gen0} -> {sg.generation}")
                merge_launches[f"{name}_merges"] = merges
            times["sharded_mixed_ms"] = apply_ms["mixed"]
            ref, gc = g.to_csr(), dist.gather_csr(sg)
            for f in ("offsets", "dst", "wgt"):
                if not same_bits(getattr(gc, f), getattr(ref, f)):
                    raise AssertionError(f"sharded/update: gather_csr {f} differs from the "
                                         f"DiGraph's to_csr")
            del gc, ref
            say("sharded", card=card, **{f"{k_}_ms": f"{v_:.1f}" for k_, v_ in apply_ms.items()},
                **merge_launches, m=sg.m,
                vs_digraph="gather_csr bit-identical to to_csr after the same plans")

            # 4. durable: a full then a differential checkpoint, a crash at
            # durable.post_append, recover(parallel=True) on the card
            twin = twin_sharded(sg, dist)
            t0 = sync_now()
            dg = durable.DurableGraph(sg, wal, ck, diff=True, keep=2)
            times["sharded_ckpt_full_ms"] = sync_s(t0) * 1e3
            base = dist.gather_csr(sg)
            dplans = [draw(base) for _ in range(4)]
            del base
            with counted(KERNELS, phase):
                dg.apply(dplans[0])
            t0 = sync_now()
            path = dg.checkpoint()
            times["sharded_ckpt_diff_ms"] = sync_s(t0) * 1e3
            with open(os.path.join(path, "manifest.json")) as f:
                man = json.load(f)
            if man["kind"] != "diff":
                raise AssertionError(f"sharded/durable: the second step is {man['kind']}")
            diff_bytes = sum(b_["diff_bytes"] for b_ in man["shards"].values())
            with counted(KERNELS, phase):
                dg.apply(dplans[1])
                dg.apply(dplans[2])
            crash_at(faultinject, "durable.post_append", lambda: dg.apply(dplans[3]))
            dg.close()
            for plan in dplans:
                twin.apply(plan)
            del dg, sg
            torch.cuda.empty_cache()
            st = {}
            t0 = sync_now()
            with counted(KERNELS, phase):
                r = durable.DurableGraph.recover(wal, ck, device=dev, parallel=True, diff=True,
                                                 keep=2, stats=st)
            times["sharded_recover_ms"] = sync_s(t0) * 1e3
            if st["records"] != 3 or r.seq != 4 or r.rep_name != "sharded":
                raise AssertionError(f"sharded/durable: replayed {st['records']} records "
                                     f"to seq {r.seq}")
            if r.rep.generation or twin.generation:
                raise AssertionError("sharded/durable: a global re-shard ran")
            assert_same_sharded(r.rep, twin, "sharded/recovered", dist)
            say("sharded", card=card, ckpt_full_ms=f"{times['sharded_ckpt_full_ms']:.1f}",
                ckpt_full_bytes=dir_bytes(os.path.join(ck, "step_0000000000")),
                ckpt_diff_ms=f"{times['sharded_ckpt_diff_ms']:.1f}",
                ckpt_diff_persisted_bytes=diff_bytes,
                crash="durable.post_append at record 4", records=st["records"],
                recover_ms=f"{times['sharded_recover_ms']:.1f}",
                restore_ms=f"{st['restore_s'] * 1e3:.1f}",
                replay_ms=f"{st['replay_s'] * 1e3:.1f}", replay="parallel, a thread a shard",
                state_trees="every shard bit-identical to the twin")

            # 5. failover on the recovered graph
            fplan = draw(dist.gather_csr(twin))
            routed = dist.route_updates(fplan, SHARDS, r.rep.rows_max)
            victim = routed[0][0]
            faultinject.arm("shard.patch", times=1)
            try:
                with counted(KERNELS, phase):
                    r.apply(fplan)  # the first routed shard's patch faults
            finally:
                faultinject.disarm()
            twin.apply(fplan)
            if r.rep.down != {victim} or len(r.rep.spooled(victim)) != 1:
                raise AssertionError(f"sharded/failover: down {r.rep.down}, spooled "
                                     f"{len(r.rep.spooled(victim))}")
            for s_ in range(SHARDS):  # the rest patched
                if s_ != victim and not same_bits(r.rep.shards[s_].dst, twin.shards[s_].dst):
                    raise AssertionError(f"sharded/failover: healthy shard {s_} differs")
            down = r.rep.down_rows()
            vd = walk_steps(lambda: r.rep.reverse_walk(4), 4 * (SHARDS - 1), "degraded walk")
            if bool((vd[torch.from_numpy(down).to(dev)] != 0).any()):
                raise AssertionError("sharded/failover: a down row reads non-zero")
            masked = launch_serve.GenerationOracle(dist.gather_csr(twin)).walk(
                0, torch.ones(n, device=dev), 4, drop_rows=down)
            healthy = torch.ones(n, dtype=torch.bool, device=dev)
            healthy[torch.from_numpy(down).to(dev)] = False
            held = hold_walk(vd[healthy], masked[healthy], hub[healthy],
                             "sharded/degraded walk")
            del vd, masked
            coverage = r.rep.coverage
            # silent damage, on a copy of two healthy shards: dst (integrity
            # off) is caught by the structural audit; wgt only by audit_shard
            # with integrity on (the other shards quarantined in the copy, so
            # only the damaged one is hashed)
            h_dst, h_wgt = [s_ for s_ in range(SHARDS) if s_ != victim][:2]
            probe = twin_sharded(r.rep, dist)
            failover.corrupt_shard(probe, h_dst, kind="dst")
            try:
                probe.audit_shard(h_dst)
            except faultinject.AuditError as e:
                dst_caught = str(e)
            else:
                raise AssertionError("sharded/failover: a SENTINEL dst slot passed the audit")
            for s_ in range(SHARDS):
                if s_ != h_wgt:
                    probe.quarantine(s_)
            probe.enable_integrity()
            failover.corrupt_shard(probe, h_wgt, kind="wgt")
            probe.shards[h_wgt].audit()  # structurally valid
            probe.audit_shard(h_wgt, verify=False)
            try:
                probe.audit_shard(h_wgt)
            except dist.ShardIntegrityError as e:
                wgt_caught = str(e)
            else:
                raise AssertionError("sharded/failover: a flipped weight passed the CRC audit")
            del probe
            t0 = sync_now()
            with counted(KERNELS, phase):
                rebuilt = r.rebuild_shard(victim)
            times["sharded_rebuild_ms"] = sync_s(t0) * 1e3
            if r.rep.down or r.rep.coverage != 1.0:
                raise AssertionError(f"sharded/failover: still down {r.rep.down}")
            gr, gt = dist.gather_csr(r.rep), dist.gather_csr(twin)
            for f in ("offsets", "dst", "wgt"):
                if not same_bits(getattr(gr, f), getattr(gt, f)):
                    raise AssertionError(f"sharded/failover: rebuilt gather_csr {f} differs")
            del gr, gt
            hold_walk(walk_steps(lambda: r.rep.reverse_walk(4), 4 * SHARDS, "rebuilt walk"),
                      twin.reverse_walk(4), hub, "sharded/rebuilt walk")
            say("sharded", card=card, fault="shard.patch", victim=victim,
                spooled=1, coverage=f"{coverage:.6f}", down_rows=int(down.shape[0]),
                degraded_walk="down rows exact 0; the rest vs a masked float64 walk",
                **{f"degraded_{k_}": f"{v_:.3e}" for k_, v_ in held.items()},
                dst_corruption=f"shard {h_dst}: {dst_caught}",
                wgt_corruption=f"shard {h_wgt}: caught only with integrity on: {wgt_caught}",
                rebuilt=f"shard {victim}: {rebuilt} records and its spool",
                rebuild_ms=f"{times['sharded_rebuild_ms']:.1f}", coverage_after=1.0,
                vs_twin="gather_csr bit-identical, walk at the walk tolerances")
            r.close()
            del r
            torch.cuda.empty_cache()

            # 6. serving over the sharded graph, with one shard.walk fault
            oracle = launch_serve.GenerationOracle(dist.gather_csr(twin))
            srv = serve_mod.WalkServer(twin, batch_max=SERVE_BATCH, dispatch_retries=4).start()
            try:
                faultinject.arm("shard.walk", after=2 * SHARDS + 1, times=1)
                with counted(KERNELS, phase):
                    t0 = time.monotonic()
                    walks, upds = launch_serve.run_traffic(
                        srv, n, requests=SHARD_SERVE_REQUESTS, steps=SERVE_STEPS,
                        seeds_per_request=SERVE_SEEDS, update_every=SERVE_UPDATE_EVERY,
                        update_size=SERVE_UPDATE_SIZE, seed=SERVE_SEED, submit_gap_s=0.002)
                    for t_ in walks + [u_ for u_, _ in upds]:
                        if not t_.wait(120.0):
                            raise AssertionError("sharded/serve: a ticket is still pending")
                    wall = time.monotonic() - t0
                fired = faultinject.fired("shard.walk")
            finally:
                faultinject.disarm()
                srv.stop(timeout=120.0)
            stats = srv.assert_no_lost()
            torn, checked = launch_serve.count_torn_reads(oracle, walks, upds,
                                                          down_rows_of=down_rows_of(twin))
            served = [t_ for t_ in walks if t_.status == serve_mod.SERVED]
            degraded = [t_ for t_ in served if t_.coverage < 1.0]
            if (torn or checked != len(served) or fired != 1 or stats["failed"]
                    or stats["shard_quarantines"] != 1 or not degraded
                    or len(twin.down) != 1):
                raise AssertionError(
                    f"sharded/serve: torn {torn} of {checked}, fired {fired}, failed "
                    f"{stats['failed']}, quarantines {stats['shard_quarantines']}, "
                    f"degraded {len(degraded)}, down {twin.down}")
            pct = launch_serve.percentiles([t_.latency_s for t_ in served])
            times["sharded_serve_p50_ms"] = pct["p50_ms"]
            times["sharded_serve_p99_ms"] = pct["p99_ms"]
            say("sharded", card=card, serve_requests=SHARD_SERVE_REQUESTS, served=len(served),
                submitted=stats["submitted"], lost=0, failed=stats["failed"],
                batches=stats["batches"], max_batch=stats["max_batch"],
                updates=stats["updates_applied"], fault="shard.walk", fired=fired,
                quarantined=sorted(twin.down), dispatch_retries=stats["dispatch_retries"],
                served_degraded=stats["served_degraded"],
                min_coverage=f"{min(t_.coverage for t_ in served):.6f}",
                **{k_: f"{v_:.2f}" for k_, v_ in pct.items()},
                req_per_s=f"{len(served) / wall:.1f}", torn_reads=torn, torn_checked=checked)
            del srv, twin, oracle
        if any(pc.values()) or any(pm.values()):
            raise AssertionError(f"sharded: plain versions ran: {pc} {pm}")
        for k_ in ("tile_cumsum", "merge_rows_fused"):
            if phase[k_] == 0:
                raise AssertionError(f"sharded: {k_} never launched")
        for k_, v_ in phase.items():
            launches[k_] += v_
        say("sharded", card=card,
            launches="/".join(f"{k_}={v_}" for k_, v_ in phase.items() if v_),
            plain_calls=0, phase_peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            disk_peak_bytes=dir_bytes(root), phase_s=f"{time.perf_counter() - p0:.1f}")
    finally:
        faultinject.disarm()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def rebuild_shard_2(srv) -> int:
    """The closed loop's admin function (module-level: on the mesh every rank
    runs it, so it is pickled by reference): rebuild shard 2."""
    return srv.rep.rebuild_shard(2)


def serve_script(srv, plan, seeds) -> dict:
    """The mesh phase's closed serving loop, every ticket waited for: a walk;
    an update, acked; a walk; the walk whose ``shard.walk`` fault (armed by
    the caller) fires on shard 2, served degraded on its retry;
    ``rebuild_shard(2)`` through ``run_on_writer`` and its reseal; a walk.
    -> the responses (visits on the card, generation, coverage, down
    shards), the update's ΔM and ack generation, the records rebuilt and
    the deterministic counters."""
    def walk():
        t = srv.submit_walk(seeds, steps=SERVE_STEPS)
        if not t.wait(MESH_SERVE_WAIT_S):
            raise AssertionError("serve script: a walk is still pending")
        t.result()
        return t

    done = [walk()]
    u = srv.submit_update(plan)
    dm = u.result(MESH_SERVE_WAIT_S)
    done += [walk(), walk()]
    records = srv.run_on_writer(rebuild_shard_2, reseal=True).result(MESH_SERVE_WAIT_S)
    deadline = time.monotonic() + MESH_SERVE_WAIT_S
    while srv.stats()["coverage"] != 1.0:
        if time.monotonic() > deadline:
            raise AssertionError("serve script: never resealed at full coverage")
        time.sleep(0.01)
    done.append(walk())
    stats = srv.stats()
    return {"walks": [(t.visits, t.generation, t.coverage, list(t.down_shards)) for t in done],
            "dm": int(dm), "ack_generation": u.generation, "records": int(records),
            "counters": {k: stats[k] for k in ("served", "updates_applied", "seals",
                                               "shard_quarantines", "dispatch_retries",
                                               "admin_ops")}}


def mesh_open_loop(srv, n: int, launch_serve) -> dict:
    """Rank 0's open-loop level: one B = 16 batch timed (a single walk
    first, the 16 queued behind it, so they go as one batch), then the
    sharded phase's traffic.  -> the tickets and the level's times."""
    rng = np.random.default_rng(SERVE_VERIFY_SEED)
    probe = [srv.submit_walk(rng.integers(0, n, SERVE_SEEDS), steps=SERVE_STEPS)]
    while srv.stats()["queue_depth"]:
        time.sleep(0.0005)
    probe += [srv.submit_walk(rng.integers(0, n, SERVE_SEEDS), steps=SERVE_STEPS)
              for _ in range(SERVE_BATCH)]
    for t_ in probe:
        if not t_.wait(MESH_SERVE_WAIT_S):
            raise AssertionError("mesh_serve: a probe walk is still pending")
    one_batch = srv.stats()["batches"] == 2
    b16_ms = (max(t_.resolved_at for t_ in probe[1:]) - probe[0].resolved_at) * 1e3
    t0 = time.monotonic()
    walks, upds = launch_serve.run_traffic(
        srv, n, requests=SHARD_SERVE_REQUESTS, steps=SERVE_STEPS,
        seeds_per_request=SERVE_SEEDS, update_every=SERVE_UPDATE_EVERY,
        update_size=SERVE_UPDATE_SIZE, seed=SERVE_SEED, submit_gap_s=0.002)
    for t_ in walks + [u_ for u_, _ in upds]:
        if not t_.wait(MESH_SERVE_WAIT_S):
            raise AssertionError("mesh_serve: a ticket is still pending")
    return {"probe": probe, "walks": walks, "upds": upds, "wall_s": time.monotonic() - t0,
            "b16_ms": b16_ms if one_batch else None}


def mesh_rank(mesh, root: str) -> dict:
    """One rank of the mesh phase, in its own process (see the module
    docstring): shard ``mesh.rank`` of the social graph on ``mesh.device``,
    driven through ShardedGraph on the mesh, every result held against the
    local mode's files under ``root``.  -> its kernel launches (main-path
    calls only), times and exchange counts.  A failed check raises, which
    takes the other ranks down and fails the phase."""
    from repro_torch.core import csr, distributed as dist, updates
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.slot_update import ops as su_ops
    from repro_torch.kernels.slot_walk import sharded as sw_sharded
    from repro_torch.launch import serve as launch_serve
    from repro_torch.runtime import durable, faultinject, serve as serve_mod

    dev, rank = mesh.device, mesh.rank
    with open(os.path.join(root, "meta.json")) as f:
        meta = json.load(f)
    n, m = meta["n"], meta["m"]
    phase = dict.fromkeys(KERNELS, 0)
    t, ex = {}, sw_sharded.EXCHANGE

    def on_card(name):
        return torch.from_numpy(np.load(os.path.join(root, name + ".npy"))).to(dev)

    def plan_of(name):
        z = np.load(os.path.join(root, name + ".npz"))
        return updates.plan_from_canonical(z["q_src"], z["q_dst"], z["q_wgt"], z["q_del"])

    def check(ok, what):
        if not ok:
            raise AssertionError(f"mesh/rank {rank}: {what}")

    def same_csr(got, prefix, what):
        for f in ("offsets", "dst", "wgt"):
            x = getattr(got, f)
            check(same_bits(x if f == "offsets" else x[: got.m], on_card(prefix + f)),
                  f"{what}: gather_csr {f} differs")

    def timed(call):
        """``call()`` inside ``counted``, every rank starting together; ->
        (its result, host ms)."""
        mesh.barrier()
        t0 = sync_now()
        with counted(KERNELS, phase):
            out = call()
        return out, sync_s(t0) * 1e3

    def walk_launches(call, want, what):
        before = phase["tile_cumsum"]
        with counted(KERNELS, phase):
            out = call()
        check(phase["tile_cumsum"] - before == want,
              f"{what}: tile_cumsum launched {phase['tile_cumsum'] - before} times, not {want}")
        return out

    c = csr.CSR(offsets=on_card("offsets"), dst=on_card("dst"), wgt=on_card("wgt"), n=n, m=m)
    # 1. build (this rank's shard only) and the CSR back on every rank
    sg, t["mesh_build_ms"] = timed(lambda: dist.shard_csr(c, SHARDS, mesh=mesh))
    check([s for s, img in enumerate(sg.shards) if img is not None] == [rank],
          "holds another rank's shard")
    rows_max = sg.rows_max
    same_csr(dist.gather_csr(sg), "", "build")
    shard_bytes = sum(x.numel() * x.element_size()
                      for x in (sg.shards[rank].dst, sg.shards[rank].wgt, sg.shards[rank].rows))

    # 2. walks, against the local mode's, bit for bit
    sg.reverse_walk(1)  # warm-up
    ex0 = dict(ex)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    mesh.barrier()
    t0 = sync_now()
    start.record()
    v = walk_launches(lambda: sg.reverse_walk(WALK_STEPS), WALK_STEPS, "walk/42")
    end.record()
    t["mesh_walk_ms"] = sync_s(t0) * 1e3
    t["mesh_step_event_ms"] = start.elapsed_time(end) / WALK_STEPS
    t["mesh_exchange_host_ms"] = (ex["host_s"] - ex0["host_s"]) / WALK_STEPS * 1e3
    check(ex["steps"] - ex0["steps"] == WALK_STEPS, "walk/42: exchanges")
    check(same_bits(v, on_card("walk42")), "the 42-step walk differs from the local mode's")
    del v
    v0 = on_card("v0")
    ex0 = dict(ex)
    b16 = walk_launches(lambda: sg.reverse_walk(4, visits0=v0), 4, "walk/B=16")
    bytes16 = (ex["bytes"] - ex0["bytes"]) // 4
    check(same_bits(b16, on_card("walk_b16")), "the B = 16 walk differs from the local mode's")
    del b16
    t["mesh_walk_b16_ms"] = time_ms(lambda: sg.reverse_walk(4, visits0=v0), reps=5)
    bytes1 = sg.collective_bytes_per_step(1)
    check(bytes1 == (SHARDS - 1) * rows_max * 4 and bytes16 == 16 * bytes1,
          f"exchange bytes a step {bytes1} (B = 1), {bytes16} (B = 16)")

    # 3. the update phase's plans, routed: a patch on this rank if routed here
    patched = {}
    for name in meta["plans"]:
        plan = plan_of("plan_" + name)
        here = rank in {s for s, _ in dist.route_updates(plan, SHARDS, rows_max)}
        with count_calls(su_ops, ("fused_apply",)) as fa:
            _, t[f"mesh_{name}_ms"] = timed(lambda: sg.apply(plan))
        check(fa["fused_apply"] == int(here) and sg.generation == 0,
              f"{name}: {fa['fused_apply']} patches (routed here: {here}), "
              f"generation {sg.generation}")
        patched[name] = fa["fused_apply"]
    same_csr(dist.gather_csr(sg), "ref_", "after the plans")
    v = walk_launches(lambda: sg.reverse_walk(4), 4, "walk after the plans")
    check(same_bits(v, on_card("walk4")), "the walk after the plans differs")

    # 4. durable; a shard.walk fault on rank 2 alone, raised on every rank;
    # the degraded walk; rank 2's shard rebuilt
    wal, ck = os.path.join(root, "wal"), os.path.join(root, "ckpt")
    dg, t["mesh_ckpt_ms"] = timed(lambda: durable.DurableGraph(sg, wal, ck))
    if rank == 2:
        faultinject.arm("shard.walk", times=1)
    raised = None
    try:
        sg.reverse_walk(4)
    except dist.ShardFaultError as e:
        raised = e.sid
    finally:
        faultinject.disarm()
    check(raised == 2, f"shard.walk on rank 2 raised ShardFaultError({raised}) here")
    sg.quarantine(2)
    check(sg.coverage == meta["coverage"], f"coverage {sg.coverage}")
    vd = walk_launches(lambda: sg.reverse_walk(4), 0 if rank == 2 else 4, "degraded walk")
    lo, hi = sg.owned_range(2)
    check(not bool(vd[lo:hi].any()), "a down row reads non-zero")
    check(same_bits(vd, on_card("degraded4")), "the degraded walk differs from the local mode's")
    del vd
    records, t["mesh_rebuild_ms"] = timed(lambda: dg.rebuild_shard(2))
    check(not sg.down and sg.coverage == 1.0, f"still down: {sg.down}")
    v = walk_launches(lambda: sg.reverse_walk(4), 4, "rebuilt walk")
    check(same_bits(v, on_card("walk4")), "the walk after rebuild_shard differs")

    # 5. a crash at durable.post_append (armed on every rank: the job dies)
    # and recover(mesh=), against an uncrashed twin on the mesh
    twin = dist.ShardedGraph(shards=[None if i is None else twin_image(i) for i in sg.shards],
                             n=sg.n, rows_max=rows_max, n_shards=SHARDS, mesh=mesh,
                             dense=sg.dense)
    dplans = [plan_of(f"dplan_{i}") for i in range(3)]
    with counted(KERNELS, phase):
        dg.apply(dplans[0])
        dg.apply(dplans[1])
    crash_at(faultinject, "durable.post_append", lambda: dg.apply(dplans[2]))
    dg.close()
    for p in dplans:
        twin.apply(p)
    del dg, sg
    torch.cuda.empty_cache()
    st = {}
    r, t["mesh_recover_ms"] = timed(lambda: durable.DurableGraph.recover(wal, ck, mesh=mesh,
                                                                          stats=st))
    check(st["records"] == 3 and r.seq == 3 and r.rep_name == "sharded",
          f"replayed {st['records']} records to seq {r.seq}")
    ta, tb = r.rep.state_trees()[rank], twin.state_trees()[rank]
    for key in tb:
        check(same_bits(ta[key], tb[key]), f"recovered state_trees[{key!r}] differs from the twin")
    del ta, tb, twin
    t["mesh_restore_ms"], t["mesh_replay_ms"] = st["restore_s"] * 1e3, st["replay_s"] * 1e3

    # 6. vertex growth: every rank re-shards from the gathered edges
    _, t["mesh_grow_ms"] = timed(lambda: r.apply(plan_of("grow")))
    check(r.rep.n == n + 7 and r.rep.generation == 1, f"grown to n={r.rep.n}")
    v = walk_launches(lambda: r.reverse_walk(4), 4, "walk after growth")
    check(same_bits(v, on_card("grow4")), "the walk after growth differs")
    del v

    # 7. serving the grown graph: rank 0's WalkServer, the other ranks
    # following it.  The closed loop bit for bit against the local mode's
    # (its shard.walk fault on rank 2's shard, after its first two walks)
    sv, served, ops = meta["serve"], dict.fromkeys(KERNELS, 0), {}
    _, t["mesh_serve_ckpt_ms"] = timed(r.checkpoint)  # rebuild_shard's base after the re-shard
    srv = serve_mod.WalkServer(r, batch_max=SERVE_BATCH, dispatch_retries=4)
    if rank == 2:
        faultinject.arm("shard.walk", after=MESH_SERVE_FAULT_WALKS, times=1)
    secs = {}
    s0 = time.perf_counter()
    try:
        with counted(KERNELS, served):
            srv.start()
            try:
                script = (serve_script(srv, plan_of("serve_plan"), np.asarray(sv["seeds"]))
                          if rank == 0 else None)
            finally:
                srv.stop(timeout=MESH_SERVE_WAIT_S)
        fired = faultinject.fired("shard.walk")
    finally:
        faultinject.disarm()
    check(fired == int(rank == 2), f"serve script: shard.walk fired {fired} times here")
    ops["closed"] = srv.op_counts()
    if rank == 0:
        for i, (vis, gen, cov, down) in enumerate(script.pop("walks")):
            check(same_bits(vis, on_card(f"serve_walk{i}")),
                  f"serve script: walk {i}'s visits differ from the local mode's")
            check([gen, cov, down] == sv["walks"][i],
                  f"serve script: walk {i} served at {(gen, cov, down)}, local mode "
                  f"{sv['walks'][i]}")
        check(script == sv["rest"], f"serve script: {script} vs the local mode's {sv['rest']}")
        del vis
    secs["closed_s"] = time.perf_counter() - s0

    # 8. the open-loop level: 120 four-step walks 2 ms apart, an update of
    # 256 every 10, one shard.walk fault (rank 1's shard), every served walk
    # against the per-generation oracle
    s0 = time.perf_counter()
    gc = dist.gather_csr(r.rep)
    oracle = launch_serve.GenerationOracle(gc) if rank == 0 else None
    del gc
    secs["oracle_s"], s0 = time.perf_counter() - s0, time.perf_counter()
    srv = serve_mod.WalkServer(r, batch_max=SERVE_BATCH, dispatch_retries=4)
    if rank == MESH_OPEN_FAULT_SHARD:
        faultinject.arm("shard.walk", after=MESH_OPEN_FAULT_AFTER, times=1)
    try:
        with counted(KERNELS, served):
            srv.start()
            try:
                level = mesh_open_loop(srv, r.rep.n, launch_serve) if rank == 0 else None
            finally:
                srv.stop(timeout=MESH_SERVE_WAIT_S)
        fired = faultinject.fired("shard.walk")
    finally:
        faultinject.disarm()
    check(fired == int(rank == MESH_OPEN_FAULT_SHARD),
          f"open loop: shard.walk fired {fired} times here")
    ops["open"] = srv.op_counts()
    secs["open_s"] = time.perf_counter() - s0
    serve_out = {"launches": served, "ops": ops, "down": sorted(r.rep.down), "secs": secs}
    for k_ in ("tile_cumsum", "merge_rows_fused"):
        check(served[k_] > 0, f"serving: {k_} never launched on this rank")
    if rank == 0:
        stats = srv.assert_no_lost()
        walks = level["probe"] + level["walks"]
        torn, checked = launch_serve.count_torn_reads(oracle, walks, level["upds"],
                                                      down_rows_of=down_rows_of(r.rep))
        done = [t_ for t_ in level["walks"] if t_.status == serve_mod.SERVED]
        degraded = [t_ for t_ in done if t_.coverage < 1.0]
        # the faulted batch is retried after the writer round that
        # quarantines its shard: on the degraded generation
        retried = [t_ for t_ in done if t_.attempts]
        check(torn == 0 and checked == stats["served"] == len(walks) and not stats["failed"]
              and stats["shard_quarantines"] == 1 and degraded and retried
              and all(t_.coverage < 1.0 for t_ in retried)
              and stats["down_shards"] == (MESH_OPEN_FAULT_SHARD,)
              and r.rep.down == {MESH_OPEN_FAULT_SHARD},
              f"open loop: torn {torn} of {checked}, {len(degraded)} degraded, retried at "
              f"{[t_.coverage for t_ in retried]}, stats {stats}, down {r.rep.down}")
        first_degraded = min(t_.resolved_at for t_ in degraded)
        pct = launch_serve.percentiles([t_.latency_s for t_ in done])
        acks = launch_serve.percentiles([u_.resolved_at - u_.submitted_at
                                         for u_, _ in level["upds"]
                                         if u_.status == serve_mod.SERVED])
        serve_out.update(
            script=script, p50_ms=pct["p50_ms"], p99_ms=pct["p99_ms"],
            req_per_s=len(done) / level["wall_s"], ack_p99_ms=acks["p99_ms"],
            b16_ms=level["b16_ms"], served=len(done), degraded=len(degraded),
            updates=stats["updates_applied"], batches=stats["batches"], seals=stats["seals"],
            max_batch=stats["max_batch"], dispatch_retries=stats["dispatch_retries"],
            torn_reads=torn, torn_checked=checked,
            min_coverage=min(t_.coverage for t_ in done), final_coverage=stats["coverage"],
            before_degraded=sum(t_.resolved_at < first_degraded for t_ in done),
            fault_retry_ms=max(t_.latency_s for t_ in retried) * 1e3)
        del oracle, level, walks, done, degraded, retried
    for k_, v_ in served.items():
        phase[k_] += v_
    r.close()
    return {"rank": rank, "backend": mesh.backend, "device": str(dev), "launches": phase,
            "times": t, "rows_max": rows_max, "bytes1": bytes1, "bytes16": bytes16,
            "patched": patched, "records_rebuilt": records, "shard_bytes": shard_bytes,
            "serve": serve_out, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def mesh_phase(c, g, plans, launches: dict, times: dict, dev, card: str) -> None:
    """The mesh phase (see the module docstring).  ``c`` is the social CSR on
    the card, ``g`` the update phase's DiGraph (after ``plans``).  The local
    mode runs here first and writes what the ranks hold themselves against
    (the CSR's host arrays, its walks, the plans) under
    ``build/chip_smoke_mesh_<pid>/``, with the ranks' journal and
    checkpoints; removed on the way out whether the checks pass or not."""
    from repro_torch.core import distributed as dist, edgebatch, updates, util
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve as launch_serve
    from repro_torch.runtime import durable, faultinject, serve as serve_mod

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"chip_smoke_mesh_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    p0 = time.perf_counter()
    n = int(c.n)

    def save(name, x):
        np.save(os.path.join(root, name + ".npy"), util.host(x))

    def save_plan(name, plan):
        np.savez(os.path.join(root, name + ".npz"), q_src=plan.q_src, q_dst=plan.q_dst,
                 q_wgt=plan.q_wgt, q_del=plan.q_del)

    try:
        # the local mode: the same steps on 4 shards of the one card
        for f in ("offsets", "dst", "wgt"):
            save(f, getattr(c, f)[: c.m if f != "offsets" else None])
        wrng = np.random.default_rng(SERVE_VERIFY_SEED)
        v0 = torch.stack([launch_serve.seed_visits_row(n, wrng.integers(0, n, SERVE_SEEDS),
                                                       device=dev)
                          for _ in range(SERVE_BATCH)])
        save("v0", v0)
        sg = dist.shard_csr(c, SHARDS, device=dev)
        save("walk42", sg.reverse_walk(WALK_STEPS))
        save("walk_b16", sg.reverse_walk(4, visits0=v0))
        for name, plan in plans:
            sg.apply(plan)
            save_plan("plan_" + name, plan)
        ref = g.to_csr()
        for f in ("offsets", "dst", "wgt"):
            save("ref_" + f, getattr(ref, f)[: ref.m if f != "offsets" else None])
        save("walk4", sg.reverse_walk(4))
        sg.quarantine(2)
        coverage = sg.coverage
        save("degraded4", sg.reverse_walk(4))
        sg.reintegrate(2, twin_image(sg.shards[2]))
        rng = np.random.default_rng(SEED + 3)
        k = max(round(SHARD_PLAN_FRAC * ref.m), 1)
        for i in range(3):
            plan = updates.plan_update(inserts=edgebatch.random_insertions(rng, n, k),
                                       deletes=edgebatch.random_deletions(rng, ref, k))
            sg.apply(plan)
            save_plan(f"dplan_{i}", plan)
        grow = updates.plan_update(inserts=edgebatch.from_arrays(
            np.array([n + 6, 2]), np.array([1, n + 6]), np.ones(2, np.float32)))
        sg.apply(grow)
        save_plan("grow", grow)
        save("grow4", sg.reverse_walk(4))
        # the closed serving loop over a DurableGraph of the grown graph,
        # its shard.walk fault on shard 2 (after the first two walks' checks
        # of every shard and the third's of shards 0 and 1)
        srng = np.random.default_rng(SERVE_SEED)
        splan = updates.plan_update(
            inserts=edgebatch.random_insertions(srng, sg.n, SERVE_UPDATE_SIZE))
        save_plan("serve_plan", splan)
        sseeds = srng.integers(0, sg.n, SERVE_SEEDS)
        ls0 = time.perf_counter()
        dg = durable.DurableGraph(sg, os.path.join(root, "local_wal"),
                                  os.path.join(root, "local_ckpt"))
        srv = serve_mod.WalkServer(dg, batch_max=SERVE_BATCH, dispatch_retries=4,
                                   retry_backoff=MESH_SERVE_BACKOFF_S)
        faultinject.arm("shard.walk", after=MESH_SERVE_FAULT_WALKS * SHARDS + 2, times=1)
        try:
            srv.start()
            try:
                script = serve_script(srv, splan, sseeds)
            finally:
                srv.stop(timeout=MESH_SERVE_WAIT_S)
        finally:
            faultinject.disarm()
        dg.close()
        shutil.rmtree(os.path.join(root, "local_wal"))
        shutil.rmtree(os.path.join(root, "local_ckpt"))
        local_serve_s = time.perf_counter() - ls0
        walks = script.pop("walks")
        for i, (vis, _, _, _) in enumerate(walks):
            save(f"serve_walk{i}", vis)
        (_, _, cov, down), = [w for w in walks if w[2] < 1.0]
        if down != [2] or script["records"] != 1 or script["counters"]["dispatch_retries"] != 1:
            raise AssertionError(f"mesh/serve: the local mode's script served {walks[1:]} "
                                 f"and {script}")
        with open(os.path.join(root, "meta.json"), "w") as f:
            json.dump({"n": n, "m": int(c.m), "plans": [name for name, _ in plans],
                       "coverage": coverage,
                       "serve": {"seeds": sseeds.tolist(), "rest": script,
                                 "walks": [[g_, c_, d_] for _, g_, c_, d_ in walks]}}, f)
        serve_coverage = cov
        del sg, ref, v0, dg, srv, walks, vis
        torch.cuda.empty_cache()
        local_s = time.perf_counter() - p0

        # the ranks: one shard each, 4 processes on this card
        device = f"cuda:{torch.cuda.current_device()}"
        t0 = time.perf_counter()
        ranks = mesh_mod.run_ranks(mesh_rank, MESH_RANKS, args=(root,), device=device,
                                   init_dir=root, timeout=MESH_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        if sorted(r_["rank"] for r_ in ranks) != list(range(MESH_RANKS)):
            raise AssertionError(f"mesh: ranks {[r_['rank'] for r_ in ranks]} returned")
        for r_ in ranks:
            for k_, v_ in r_["launches"].items():
                launches[k_] += v_
        for k_ in ("tile_cumsum", "merge_rows_fused", "degree_offsets"):
            if sum(r_["launches"][k_] for r_ in ranks) == 0:
                raise AssertionError(f"mesh: {k_} never launched in the ranks")
        for k_ in ranks[0]["times"]:
            times[k_] = max(r_["times"][k_] for r_ in ranks)
        say("mesh", card=card, ranks=MESH_RANKS, device=device, backend=ranks[0]["backend"],
            transport="4 ranks share one card: not a multi-card figure", n=n, m=c.m,
            rows_max=ranks[0]["rows_max"],
            shard_bytes="/".join(str(r_["shard_bytes"]) for r_ in ranks),
            exchange_bytes_b1=ranks[0]["bytes1"], exchange_bytes_b16=ranks[0]["bytes16"],
            records_rebuilt=ranks[2]["records_rebuilt"], coverage_degraded=f"{coverage:.6f}",
            checks="42-step, B=16, degraded, rebuilt and grown walks and gather_csr bit for "
                   "bit vs local mode on every rank; recovered state_trees vs twin")
        for r_ in ranks:
            say("mesh", rank=r_["rank"], **{k_: f"{v_:.4f}" for k_, v_ in r_["times"].items()},
                patched="/".join(f"{k_}={v_}" for k_, v_ in r_["patched"].items()),
                launches="/".join(f"{k_}={v_}" for k_, v_ in r_["launches"].items() if v_),
                peak_gb=f"{r_['peak_gb']:.2f}")
        sv = ranks[0]["serve"]
        ops0 = {}
        for o_ in sv["ops"].values():
            for k_, v_ in o_.items():
                ops0[k_] = ops0.get(k_, 0) + v_
        if any(r_["serve"]["down"] != [MESH_OPEN_FAULT_SHARD] for r_ in ranks):
            raise AssertionError(f"mesh_serve: down {[r_['serve']['down'] for r_ in ranks]}")
        times["mesh_serve_p50_ms"], times["mesh_serve_p99_ms"] = sv["p50_ms"], sv["p99_ms"]
        times["mesh_serve_req_per_s"] = sv["req_per_s"]
        times["mesh_serve_ack_p99_ms"] = sv["ack_p99_ms"]
        if sv["b16_ms"] is not None:
            times["mesh_serve_b16_ms"] = sv["b16_ms"]
        say("mesh_serve", card=f"'{card}'",
            transport="'4 ranks on one H100 over gloo, not a multi-card figure'",
            p50_ms=f"{sv['p50_ms']:.2f}", p99_ms=f"{sv['p99_ms']:.2f}",
            req_per_s=f"{sv['req_per_s']:.2f}", ack_p99_ms=f"{sv['ack_p99_ms']:.2f}",
            b16_batch_ms="not one batch" if sv["b16_ms"] is None else f"{sv['b16_ms']:.2f}",
            served=sv["served"], degraded=sv["degraded"], updates=sv["updates"],
            batches=sv["batches"], seals=sv["seals"], max_batch=sv["max_batch"],
            dispatch_retries=sv["dispatch_retries"], lost=0, torn_reads=sv["torn_reads"],
            served_before_degraded=sv["before_degraded"],
            fault_retry_ms=f"{sv['fault_retry_ms']:.2f}",
            torn_checked=sv["torn_checked"], min_coverage=f"{sv['min_coverage']:.6f}",
            final_coverage=f"{sv['final_coverage']:.6f}",
            script="walk/update/walk/degraded walk/rebuild_shard(2)/walk bit for bit vs "
                   "local mode", script_coverage=f"{serve_coverage:.6f}",
            script_counters="/".join(f"{k_}={v_}" for k_, v_ in sv["script"]["counters"].items()),
            ops_per_rank="/".join(str(sum(sum(o_.values()) for o_ in r_["serve"]["ops"].values()))
                                  for r_ in ranks),
            ops_rank0="/".join(f"{k_}={v_}" for k_, v_ in sorted(ops0.items())),
            served_launches="; ".join(
                f"rank {r_['rank']}: " + "/".join(f"{k_}={v_}" for k_, v_ in
                                                 r_["serve"]["launches"].items() if v_)
                for r_ in ranks))
        secs = {k_: max(r_["serve"]["secs"][k_] for r_ in ranks)
                for k_ in ("closed_s", "oracle_s", "open_s")}
        say("mesh", card=card, local_mode_s=f"{local_s:.1f}",
            local_serve_s=f"{local_serve_s:.1f}", ranks_s=f"{ranks_s:.1f}",
            ranks_serve_closed_s=f"{secs['closed_s']:.1f}",
            ranks_serve_oracle_s=f"{secs['oracle_s']:.1f}",
            ranks_serve_open_s=f"{secs['open_s']:.1f}",
            disk_peak_bytes=dir_bytes(root), phase_s=f"{time.perf_counter() - p0:.1f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def gnn_runs_a_step(model: str, cfg) -> int:
    """edge_segment_runs launches a train step: one a segment sum of the
    forward (the backward is a gather).  GCN and GraphCast sum once a layer,
    SchNet once an interaction and once for the per-graph energies, MACE
    three times a layer (scalar, vector, tensor messages) and once for the
    energies."""
    if model == "schnet":
        return cfg.n_interactions + 1
    if model == "mace":
        return 3 * cfg.n_layers + 1
    return cfg.n_layers


def clone_state(state):
    """A copy of a train state whose parameters require grad, as the
    cell's own do."""
    from repro_torch.core import tree

    out = tree.tree_map(lambda t: t.detach().clone(), state)
    tree.tree_map(lambda t: t.requires_grad_(), out["params"])
    return out


def gnn_train_phase(launches: dict, times: dict, dev, card: str) -> None:
    """The gnn_train phase (see the module docstring): each of ``GNN_CELLS``
    built by ``launch.steps.build_cell`` at FULL width and trained a few
    steps, the build and the steps counted as the main path."""
    from repro_torch.core import tree, util
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.edge_segment_sum import kernel as seg_kernel
    from repro_torch.launch import steps as gnn_steps
    from repro_torch.models.gnn import common as gnn_common
    from repro_torch.models.gnn import mace as gnn_mace

    torch.cuda.empty_cache()
    say("gnn_train", resident_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}",
        card=f"'{card}'")
    plain_parts = ("pad", "edge_segment_partials_torch", "fold_live")
    keep_agg = lambda args, kwargs: ((args[0].detach(), args[1], args[2]), {})  # noqa: E731
    for arch, shape, n_steps in GNN_CELLS:
        c0 = time.perf_counter()
        name = f"{arch}/{shape}"
        sorts0 = gnn_common.edge_order.sorts
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        # the main path: the cell as a user builds it, then its train steps
        with counted(KERNELS, launches), count_calls(seg_kernel, plain_parts) as plain_calls:
            t0 = sync_now()
            cell = gnn_steps.build_cell(arch, shape, device=dev, seed=SEED)
            build_s = sync_s(t0)
            state, batch = cell.args
            cfg, model = cell.meta["cfg"], cell.meta["module"].__name__.rsplit(".", 1)[1]
            init = clone_state(state)
            sampled = "n_sub" in cell.meta
            spans, losses = [], []
            t0 = sync_now()
            for _ in range(n_steps):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                state, metrics = cell.step_fn(state, batch)
                ev[1].record()
                spans.append(ev)
                losses.append(metrics["loss"])
            steps_s = sync_s(t0)
            runs = gnn_runs_a_step(model, cfg)
            expect_launches("edge_segment_runs", n_steps * runs, f"gnn_train/{name}")
            # GCN's degree counts (once a graph); the minibatch_lg CSR's build
            expect_launches("degree_offsets", int(model == "gcn") + int(sampled),
                            f"gnn_train/{name}")
        peak_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9  # the cell's own
        step_ms = [a_.elapsed_time(b_) for a_, b_ in spans]
        sorts = gnn_common.edge_order.sorts - sorts0
        if any(plain_calls.values()):
            raise AssertionError(f"gnn_train/{name}: the kernel path called {plain_calls}")
        losses = [float(x) for x in losses]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"gnn_train/{name}: losses {losses}")
        if all(torch.equal(a_, b_) for a_, b_ in zip(tree.leaves(init["params"]),
                                                     tree.leaves(state["params"]))):
            raise AssertionError(f"gnn_train/{name}: no parameter changed")
        # one sort an id tensor: the destinations, and the graph ids of the
        # per-graph energies; once a graph, or once a step for a subgraph
        want_sorts = (1 + int(model in ("schnet", "mace"))) * (n_steps if sampled else 1)
        if sorts != want_sorts:
            raise AssertionError(f"gnn_train/{name}: {sorts} sorts, expected {want_sorts}")
        # the first step against the same step through the plain segment sum
        # on the card, from the same weights; the outputs twice (same bits),
        # the first keeping the messages of its largest aggregate
        with torch.no_grad():
            with largest_call(gnn_common, "segment_sum", lambda a: a[0].numel(),
                              keep_agg) as agg:
                out = cell.forward(init["params"], batch)
            same_bits = torch.equal(out, cell.forward(init["params"], batch))
            out_p = cell.forward(init["params"], batch, backend="torch")
        if not same_bits:
            raise AssertionError(f"gnn_train/{name}: two forwards gave other bits")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"gnn_train/{name}: non-finite outputs")
        out_scale = float(out_p.abs().max())
        out_diff = float((out - out_p).abs().max())
        if out_diff > GNN_RTOL * out_scale:
            raise AssertionError(f"gnn_train/{name}: outputs {out_diff:.3e} from the plain "
                                 f"sum's (max|out| {out_scale:.3e})")
        del out, out_p
        _, metrics_p = cell.with_backend("torch")(init, batch)
        loss_p = float(metrics_p["loss"])
        if abs(losses[0] - loss_p) > GNN_RTOL * abs(loss_p):
            raise AssertionError(f"gnn_train/{name}: loss {losses[0]} against the plain "
                                 f"sum's {loss_p}")
        del init, metrics_p
        extra = {}
        if model == "mace":
            f = gnn_mace.forces(state["params"], cell.meta["graph"](batch), cfg)
            if tuple(f.shape) != (cell.meta["n"], 3) or not bool(torch.isfinite(f).all()):
                raise AssertionError(f"gnn_train/{name}: forces not finite of shape (n, 3)")
            extra["forces_max_abs"] = f"{float(f.abs().max()):.3e}"
            del f
        # the largest aggregate of the steps: the kernel on its sorted
        # messages, the op (gather + kernel), the sort, index_add_ on the
        # messages as the model made them; op against index_add_ within
        # 2*gamma(deg)*sum|terms| (each sum within gamma of the exact one)
        vals, seg, num = agg["args"]
        order = gnn_common.edge_order(seg, num)
        flat = vals.reshape(vals.shape[0], -1).float()
        e_agg, d_agg = flat.shape
        srt = flat.index_select(0, order.perm)
        key = order.key.long()
        lib_fn = lambda: torch.zeros((num + 1, d_agg), device=flat.device).index_add_(  # noqa: E731
            0, key, flat)
        got = gnn_common.segment_sum(vals, seg, num).reshape(num, -1).double()
        lib = lib_fn()[:num].double()
        absum = torch.zeros((num + 1, d_agg), device=flat.device).index_add_(
            0, key, flat.abs())[:num].double()
        deg = order.counts().double()[:, None]
        gamma = deg * U / (1 - deg * U)
        if not bool(((got - lib).abs() <= 2 * gamma * absum * (1 + gamma)).all()):
            raise AssertionError(f"gnn_train/{name}: the aggregate exceeds 2*gamma(deg)*"
                                 "sum|terms| from index_add_")
        agg_err = float((got - lib).abs().max())
        del got, lib, absum, deg, gamma
        agg_times = dict(
            agg_kernel_ms=time_ms(lambda: seg_kernel.edge_segment_runs(order.rows, srt, num)),
            agg_op_ms=time_ms(lambda: gnn_common.segment_sum(vals, seg, num)),
            agg_sort_ms=time_ms(lambda: gnn_common.EdgeOrder(seg, num), reps=5),
            agg_index_add_ms=time_ms(lib_fn, reps=5))
        agg_bytes = 4 * e_agg + 4 * d_agg * e_agg + 4 * d_agg * num
        times[f"gnn_{arch}_step_ms"] = step_ms[-1]
        sizes = {k_: cell.meta[k_] for k_ in ("n", "e", "n_sub") if k_ in cell.meta}
        say("gnn_train", cell=name, **sizes,
            config=",".join(f"{k_}={getattr(cfg, k_)}" for k_ in (
                "d_in", "d_hidden", "n_layers", "n_interactions", "remat", "bf16",
                "edge_chunks") if hasattr(cfg, k_)),
            build_s=f"{build_s:.2f}", steps=n_steps,
            step_ms="/".join(f"{x:.2f}" for x in step_ms), steps_host_s=f"{steps_s:.3f}",
            losses="/".join(f"{x:.6g}" for x in losses), peak_gb=f"{peak_gb:.3f}",
            edge_segment_runs_a_step=runs, sorts=sorts,
            loss_vs_plain=f"{abs(losses[0] - loss_p):.3e}",
            out_max_abs_diff_vs_plain=f"{out_diff:.3e}", out_scale=f"{out_scale:.3e}",
            bit_identical_forwards=2, plain_parts_called=0, **extra,
            agg_E=e_agg, agg_D=d_agg, agg_n=num,
            **{k_: f"{v_:.4f}" for k_, v_ in agg_times.items()},
            agg_bound_ms=f"{agg_bytes / HBM_BYTES_PER_S * 1e3:.4f}",
            agg_max_abs_diff_vs_index_add=f"{agg_err:.3e}",
            wall_s=f"{time.perf_counter() - c0:.1f}")
        del cell, state, batch, agg, vals, seg, flat, srt, key, order, lib_fn
        torch.cuda.empty_cache()
    # a small input: the SMOKE GCN cell's steps on the card against the CPU
    cells = {d_: gnn_steps.build_cell("gcn-cora", "full_graph_sm", reduced=True, device=d_)
             for d_ in (dev, torch.device("cpu"))}
    with torch.no_grad():
        tree.tree_map(lambda t, v: t.copy_(v), cells[dev].args[0]["params"],
                      cells[torch.device("cpu")].args[0]["params"])
    small = {}
    for d_, c_ in cells.items():
        st, b_ = c_.args
        small[d_.type] = [float(c_.step_fn(st, b_)[1]["loss"]) for _ in range(3)]
    np.testing.assert_allclose(small[dev.type], small["cpu"], rtol=GNN_RTOL)
    for (k_, a_), (_, b_) in zip(tree.paths(cells[dev].args[0]["params"]),
                                 tree.paths(cells[torch.device("cpu")].args[0]["params"])):
        np.testing.assert_allclose(util.host(a_), util.host(b_), rtol=1e-5, atol=1e-6,
                                   err_msg=f"gnn_train/smoke: {k_}")
    say("gnn_train", smoke="gcn-cora SMOKE, 3 steps on the card agree with the CPU "
        "(losses rtol 1e-5, params rtol 1e-5 atol 1e-6)")


def lm_flops(cfg, n_seq: int, seq: int, train: bool) -> float:
    """Model FLOPs of ``n_seq`` causal sequences of ``seq`` tokens: two a
    multiply-add of every matrix a token touches (MoE: its routed experts;
    the embedding is a gather) and 4*Hq*Dh a visible (query, key) pair; a
    train step three times the forward."""
    from repro_torch.kernels.flash_attention.kernel import visible_pairs

    d, n_layers = cfg.d_model, cfg.n_layers
    matmul = cfg.n_active_params() - cfg.vocab * d - (2 * n_layers + 1) * d
    if cfg.qkv_bias:
        matmul -= n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    attn = n_layers * n_seq * 4 * cfg.n_heads * cfg.head_dim * visible_pairs(
        seq, seq, True, cfg.sliding_window)
    fwd = 2.0 * matmul * n_seq * seq + attn
    return 3 * fwd if train else fwd


def event_pair():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def moe_spy():
    """Keep the largest ``moe_ffn`` call's tokens, router and routing knobs."""
    from repro_torch.models.transformer import moe

    return largest_call(moe, "moe_ffn", lambda a: a[0].shape[0], lambda args, kw: (
        (args[0].detach(), args[1].detach()), {"top_k": kw["top_k"], "capacity": kw["capacity"]}))


def dropped_share(seen) -> str:
    """Share of a kept ``moe_ffn`` call's assignments dropped for capacity."""
    from repro_torch.models.transformer import moe

    (x, router), kw = seen["args"], seen["kwargs"]
    r = moe.dispatch(x, router, **kw)
    return f"{int(r.dropped) / r.keep.numel():.4f} (capacity {kw['capacity']})"


def leaf_heads(params) -> dict:
    """The first 4,096 elements of every parameter leaf (a cheap copy to
    tell which leaves a step changed)."""
    from repro_torch.core import tree

    return {k: v.detach().reshape(-1)[:4096].clone() for k, v in tree.paths(params)}


def unchanged_leaves(heads: dict, params) -> tuple:
    """(float32 leaves a step left unchanged, bfloat16 ones).  A bfloat16
    leaf may stay: the warm-up's first updates (lr 1e-5) are below half a
    bfloat16 spacing of the norms' 1.0."""
    from repro_torch.core import tree

    same = [(k, v.dtype) for k, v in tree.paths(params)
            if torch.equal(heads[k], v.detach().reshape(-1)[:4096])]
    return ([k for k, dt in same if dt != torch.bfloat16],
            [k for k, dt in same if dt == torch.bfloat16])


def hold_flash(q, k, v, group: int, d: int, what: str) -> dict:
    """One layer's q/k/v through the flash kernel against the plain
    attention (rtol 2^-7, atol 2^-12*max|v|), at GQA ``group`` and head dim
    ``d``; the kernel's time and rate on the visible pairs."""
    from repro_torch.kernels.flash_attention.kernel import visible_pairs

    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    if q.shape[1] // k.shape[1] != group or q.shape[-1] != d:
        raise AssertionError(f"{what}: heads {q.shape[1]}/{k.shape[1]} of {q.shape[-1]}, "
                             f"expected group {group} at D = {d}")
    got = fa_kernel.flash_attention(q, k, v, causal=True, window=0)
    ref = fa_kernel.flash_attention_torch(q, k, v, causal=True, window=0)
    atol = 2.0**-12 * float(v.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0**-7, atol=atol)
    err = float((got.float() - ref.float()).abs().max())
    del got, ref
    s_len = q.shape[2]
    ops = q.shape[0] * q.shape[1] * 4 * q.shape[-1] * visible_pairs(s_len, s_len, True, 0)
    ms = time_ms(lambda: fa_kernel.flash_attention(q, k, v, causal=True, window=0), reps=3)
    plain_ms = time_ms(lambda: fa_kernel.flash_attention_torch(q, k, v, causal=True, window=0),
                       reps=1)
    try:  # the yardstick only: SDPA's flash backend, the same causal GQA attention
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib = f"{time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True), reps=3):.4f}"  # noqa: E501
    except (RuntimeError, NotImplementedError, TypeError) as e:
        lib = f"none: {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return {"flash_q": "x".join(map(str, q.shape)), "flash_group": group,
            "flash_max_abs_err": f"{err:.3e}", "flash_atol": f"{atol:.3e}",
            "flash_ms": f"{ms:.4f}", "flash_plain_ms": f"{plain_ms:.4f}",
            "flash_sdpa_flash_ms": lib,
            "flash_tflops_visible": f"{ops / ms / 1e9:.1f}",
            "flash_bound_ms": f"{ops / TENSOR_BF16_OPS_PER_S * 1e3:.4f}"}


def lm_train_phase(launches: dict, times: dict, dev, card: str) -> None:
    """The lm_train phase (see the module docstring): LM and two-tower
    training at full width, the large LMs' cost1 prefills and qwen3-moe's
    cost1 decode, each cell built by ``launch.steps.build_cell`` (the
    two-tower state by the same functions at its cut vocabulary) and run
    as the main path."""
    from repro_torch.configs import two_tower_retrieval
    from repro_torch.core import tree
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.embedding_bag import kernel as bag_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.models.recsys import two_tower
    from repro_torch.runtime import compression
    from repro_torch.train import loop as train_loop

    torch.cuda.empty_cache()
    say("lm_train", resident_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}", card=f"'{card}'")

    def begin():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter(), torch.cuda.memory_allocated()

    def peak(resident):
        return f"{(torch.cuda.max_memory_allocated() - resident) / 1e9:.3f}"

    def rate(flop, ms):
        return f"{flop / (ms / 1e3) / TENSOR_BF16_OPS_PER_S:.4f}"

    # -- h2o-danube-1.8b train_4k, all 24 layers (remat, bf16 moments) -----
    c0, resident = begin()
    with counted(KERNELS, launches):
        t0 = sync_now()
        cell = steps.build_cell("h2o-danube-1.8b", "train_4k", device=dev, seed=SEED)
        build_s = sync_s(t0)
        state, full = cell.args
        cfg, opt_cfg, loss = cell.meta["cfg"], cell.meta["opt_cfg"], cell.meta["loss"]
        batch = {k_: v_[:H2O_ACCUM, :H2O_UB] for k_, v_ in full.items()}
        heads = leaf_heads(state["params"])
        fns = [train_loop.make_train_step(loss, opt_cfg, grad_accum=H2O_ACCUM)] * H2O_STEPS + [
            train_loop.make_train_step(loss, opt_cfg, grad_accum=H2O_ACCUM,
                                       compress_fn=compression.make_int8_ef_compressor())]
        spans, losses = [], []
        for fn in fns:
            ev = event_pair()
            ev[0].record()
            state, metrics = fn(state, batch)
            ev[1].record()
            spans.append(ev)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        for k_ in ("flash_attention", "embedding_bag"):
            expect_launches(k_, 0, "lm_train/h2o")
    step_ms = [a_.elapsed_time(b_) for a_, b_ in spans]
    losses = [float(x) for x in losses]
    stale, _ = unchanged_leaves(heads, state["params"])
    if not all(np.isfinite(losses)) or stale:
        raise AssertionError(f"lm_train/h2o: losses {losses}, unchanged leaves {stale}")
    n_tok = H2O_ACCUM * H2O_UB * full["tokens"].shape[-1]
    flop = lm_flops(cfg, H2O_ACCUM * H2O_UB, full["tokens"].shape[-1], True)
    times["lm_train_step_ms"] = step_ms[H2O_STEPS - 1]
    say("lm_train", cell="h2o-danube-1.8b/train_4k full", layers=cfg.n_layers,
        params=cfg.n_params(), attn_impl=cfg.attn_impl, remat=cfg.remat,
        moments=str(opt_cfg.state_dtype).replace("torch.", ""),
        cut=(f"{H2O_ACCUM} microbatches of {H2O_UB} x {full['tokens'].shape[-1]} "
             f"(repro: {tuple(full['tokens'].shape)})"),
        build_s=f"{build_s:.2f}", step_ms="/".join(f"{x:.1f}" for x in step_ms),
        int8_ef_step_ms=f"{step_ms[-1]:.1f}", losses="/".join(f"{x:.6g}" for x in losses),
        tokens_per_s=f"{n_tok / step_ms[H2O_STEPS - 1] * 1e3:.1f}",
        model_tflop=f"{flop / 1e12:.2f}", model_flop_share_of_989=rate(flop, step_ms[H2O_STEPS - 1]),
        peak_gb=peak(resident), leaves_changed=len(heads), card=f"'{card}'",
        wall_s=f"{time.perf_counter() - c0:.1f}")
    del cell, state, full, batch, heads, fns, metrics

    # -- qwen3-moe-235b-a22b train_4k, cost1 (bf16 params and moments) ----
    c0, resident = begin()
    with counted(KERNELS, launches), moe_spy() as seen:
        cell = steps.build_cell("qwen3-moe-235b-a22b", "train_4k", variant="cost1", device=dev,
                                seed=SEED)
        state, full = cell.args
        cfg = cell.meta["cfg"]
        batch = {k_: v_[:MOE_TRAIN_UB] for k_, v_ in full.items()}
        heads = leaf_heads(state["params"])
        spans = []
        for _ in range(MOE_TRAIN_STEPS):
            ev = event_pair()
            ev[0].record()
            state, metrics = cell.step_fn(state, batch)
            ev[1].record()
            spans.append(ev)
        torch.cuda.synchronize()
        for k_ in ("flash_attention", "embedding_bag"):
            expect_launches(k_, 0, "lm_train/moe")
    step_ms = [a_.elapsed_time(b_) for a_, b_ in spans]
    ms = step_ms[-1]
    with torch.no_grad():
        _, lm_m = cell.meta["loss"](state["params"], batch)
    aux, lval = float(lm_m["aux"]), float(metrics["loss"])
    stale, bf16_same = unchanged_leaves(heads, state["params"])
    if not (np.isfinite(lval) and np.isfinite(aux)) or stale or len(bf16_same) == len(heads):
        raise AssertionError(f"lm_train/moe: loss {lval}, aux {aux}, unchanged leaves "
                             f"{stale + bf16_same}")
    flop = lm_flops(cfg, MOE_TRAIN_UB, batch["tokens"].shape[-1], True)
    times["moe_train_step_ms"] = ms
    say("lm_train", cell="qwen3-moe-235b-a22b/train_4k cost1", layers=cfg.n_layers,
        params=cfg.n_params(), active_params=cfg.n_active_params(),
        experts=f"{cfg.moe.n_experts} top {cfg.moe.top_k}",
        param_dtype=str(cfg.param_dtype).replace("torch.", ""),
        cut=f"microbatch {MOE_TRAIN_UB} x {batch['tokens'].shape[-1]} (repro: 16)",
        step_ms="/".join(f"{x:.1f}" for x in step_ms), loss=f"{lval:.6g}",
        aux_after=f"{aux:.6g}",
        bf16_leaves_unchanged=",".join(bf16_same) or "none",
        dropped=dropped_share(seen),
        tokens_per_s=f"{batch['tokens'].numel() / ms * 1e3:.1f}",
        model_tflop=f"{flop / 1e12:.3f}", model_flop_share_of_989=rate(flop, ms),
        peak_gb=peak(resident), card=f"'{card}'", wall_s=f"{time.perf_counter() - c0:.1f}")
    del cell, state, full, batch, heads, metrics, lm_m, seen

    # -- the cost1 prefills through flash_attention (batch 1 of 32) ---------
    for arch, group in LARGE_PREFILLS:
        c0, resident = begin()
        cell = steps.build_cell(arch, "prefill_32k", variant="cost1", device=dev, seed=SEED)
        params, toks = cell.args[0], cell.args[1][:PREFILL_BATCH]
        cfg = cell.meta["cfg"]
        step = cell.meta["make_step"](attn_impl="flash")
        step(params, toks)  # warm-up
        paths = dict(fa_kernel.flash_attention.path_launches)
        t0 = sync_now()
        with counted(KERNELS, launches), largest_call(
                fa_ops, "attention", lambda a: a[0].numel()) as fa_seen, moe_spy() as seen:
            logits = step(params, toks)
        ms = sync_s(t0) * 1e3
        expect_launches("flash_attention", cfg.n_layers, f"lm_train/{arch}/prefill")
        if fa_kernel.flash_attention.path_launches["wgmma"] != paths["wgmma"] + cfg.n_layers:
            raise AssertionError(f"lm_train/{arch}: flash_attention off the wgmma kernel")
        s_len = toks.shape[1]
        if (tuple(logits.shape) != (PREFILL_BATCH, s_len, cfg.vocab)
                or logits.dtype != cfg.compute_dtype or not bool(torch.isfinite(logits).all())):
            raise AssertionError(f"lm_train/{arch}: logits not finite of shape "
                                 f"({PREFILL_BATCH}, {s_len}, {cfg.vocab})")
        del logits
        flop = lm_flops(cfg, PREFILL_BATCH, s_len, False)
        extra = {"dropped": dropped_share(seen)} if cfg.moe is not None else {}
        held = hold_flash(*(t_.contiguous() for t_ in fa_seen["args"][:3]), group,
                          cfg.head_dim, f"lm_train/{arch}")
        key = {"qwen3-moe-235b-a22b": "moe_prefill_ms", "arctic-480b": "arctic_prefill_ms",
               "qwen2-72b": "qwen2_cost1_prefill_ms"}.get(arch, "mistral_cost1_prefill_ms")
        times[key] = ms
        say("lm_train", cell=f"{arch}/prefill_32k cost1", layers=cfg.n_layers,
            params=cfg.n_params(), heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}",
            qkv_bias=cfg.qkv_bias, cut=f"batch {PREFILL_BATCH} of 32", prefill_ms=f"{ms:.2f}",
            tokens_per_s=f"{s_len / ms * 1e3:.1f}", model_tflop=f"{flop / 1e12:.2f}",
            model_flop_share_of_989=rate(flop, ms), **extra, **held,
            peak_gb=peak(resident), card=f"'{card}'", wall_s=f"{time.perf_counter() - c0:.1f}")
        del cell, params, toks, step, fa_seen, seen
        if arch != "qwen3-moe-235b-a22b":
            continue
        # qwen3-moe's cost1 decode_32k: batch 128 against a linear cache
        # filled from the seed, the steps writing its last slots
        c0, resident = begin()
        cell = steps.build_cell(arch, "decode_32k", variant="cost1", device=dev, seed=SEED)
        params, cache, tok = cell.args
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for buf in (cache["k"], cache["v"]):
            buf.normal_(generator=gen)
        seq = cell.meta["cache_len"]
        cache["pos"] = seq - MOE_DECODE_STEPS - 1
        out, cache = cell.step_fn(params, cache, tok)  # warm-up
        tok = out.argmax(-1)
        t0 = sync_now()
        with counted(KERNELS, launches):
            for _ in range(MOE_DECODE_STEPS):
                out, cache = cell.step_fn(params, cache, tok)
                tok = out.argmax(-1)
        ms = sync_s(t0) * 1e3 / MOE_DECODE_STEPS
        db = cell.meta["batch"]
        if tuple(out.shape) != (db, 1, cfg.vocab) or not bool(torch.isfinite(out).all()) \
                or cache["pos"] != seq:
            raise AssertionError(f"lm_train/{arch}/decode: logits not finite of shape "
                                 f"({db}, 1, {cfg.vocab}) or pos {cache['pos']}")
        times["moe_decode_step_ms"] = ms
        # a token: every matrix it touches, and attention over the cache
        flop = db * (lm_flops(cfg, 1, 1, False)
                     + cfg.n_layers * 4 * cfg.n_heads * cfg.head_dim * seq)
        say("lm_train", cell=f"{arch}/decode_32k cost1", batch=db, cache_slots=seq,
            cache_gb=f"{2 * cache['k'].numel() * 2 / 1e9:.2f}", steps=MOE_DECODE_STEPS,
            decode_step_ms=f"{ms:.2f}", tokens_per_s=f"{db / ms * 1e3:.1f}",
            model_flop_share_of_989=rate(flop, ms),
            peak_gb=peak(resident), card=f"'{card}'", wall_s=f"{time.perf_counter() - c0:.1f}")
        del cell, params, cache, tok, out

    # -- two-tower train_batch at FULL width (5M-row vocabularies) ----------
    c0, resident = begin()
    cfg = dataclasses.replace(two_tower_retrieval.FULL, n_users=TT_ROWS, n_items=TT_ROWS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kb = cfg.bag_size

    def bags(nf):
        # ids in [-1, vocab), as repro's recsys cells draw them
        return torch.randint(-1, TT_ROWS, (TT_BATCH, nf, kb), generator=gen, device=dev,
                             dtype=torch.int32)

    t0 = sync_now()
    params = two_tower.init_params(cfg, generator=gen, device=dev)
    state = train_loop.init_state(tree.tree_map(lambda p: p.requires_grad_(), params),
                                  steps.OPT_CFG)
    batch = {"user_bags": bags(cfg.n_user_fields), "item_bags": bags(cfg.n_item_fields),
             "item_logq": torch.zeros((TT_BATCH,), dtype=torch.float32, device=dev)}
    build_s = sync_s(t0)
    # the first step's loss and grads, bag kernel against plain bag, and
    # the pooled fields against the plain bag (outside the count)
    rows = {t_: torch.unique(batch[f"{t_}_bags"][batch[f"{t_}_bags"] >= 0])[:TT_GRAD_ROWS].long()
            for t_ in ("user", "item")}
    first = {}
    for backend in ("cuda", "torch"):
        c = dataclasses.replace(cfg, backend=backend)
        lval, _ = two_tower.loss_fn(state["params"], batch, c)
        g = torch.autograd.grad(lval, [state["params"][t_]["table"] for t_ in ("user", "item")])
        first[backend] = (float(lval.detach()), [g_.index_select(0, rows[t_])
                                        for g_, t_ in zip(g, ("user", "item"))])
        del g, lval
    if abs(first["cuda"][0] - first["torch"][0]) > TT_RTOL * abs(first["torch"][0]):
        raise AssertionError(f"lm_train/two_tower: loss {first['cuda'][0]} against the plain "
                             f"bag's {first['torch'][0]}")
    grad_err = []
    for a_, b_ in zip(first["cuda"][1], first["torch"][1]):
        scale = float(b_.abs().max())
        grad_err.append(float((a_ - b_).abs().max()))
        if scale == 0 or grad_err[-1] > TT_RTOL * scale:
            raise AssertionError(f"lm_train/two_tower: table grad rows {grad_err[-1]:.3e} "
                                 f"from the plain bag's (max {scale:.3e})")
    table = state["params"]["user"]["table"].detach()
    idx = batch["user_bags"].reshape(-1, kb)
    wts = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    bag_atol = 2 * kb * kb * U * float(table.abs().max())
    pooled = bag_kernel.embedding_bag(table, idx, wts, "mean")
    torch.testing.assert_close(pooled, bag_kernel.embedding_bag_torch(table, idx, wts, "mean"),
                               rtol=0.0, atol=bag_atol)
    bag_ms = time_ms(lambda: bag_kernel.embedding_bag(table, idx, wts, "mean"), reps=5)
    bag_plain_ms = time_ms(lambda: bag_kernel.embedding_bag_torch(table, idx, wts, "mean"),
                           reps=3)
    valid = idx >= 0
    counts = valid.sum(dim=1)
    flat_ids, offsets = idx[valid].long(), torch.cumsum(counts, 0) - counts
    bag_lib_ms = time_ms(lambda: torch.nn.functional.embedding_bag(
        flat_ids, table, offsets, mode="mean"), reps=5)
    # the bound reads each distinct row once, the ids and weights, writes the output
    n_rows = int(torch.unique(flat_ids).numel())
    bag_bytes = n_rows * cfg.embed_dim * 4 + idx.numel() * 8 + idx.shape[0] * cfg.embed_dim * 4
    del pooled, table, wts, first, valid, counts, flat_ids, offsets
    heads = leaf_heads(state["params"])
    step = train_loop.make_train_step(
        lambda p, b: two_tower.loss_fn(p, b, cfg), steps.OPT_CFG)
    spans, losses = [], []
    with counted(KERNELS, launches):
        for _ in range(TT_STEPS):
            ev = event_pair()
            ev[0].record()
            state, metrics = step(state, batch)
            ev[1].record()
            spans.append(ev)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        expect_launches("embedding_bag", 2 * TT_STEPS, "lm_train/two_tower")
    step_ms = [a_.elapsed_time(b_) for a_, b_ in spans]
    losses = [float(x) for x in losses]
    stale, _ = unchanged_leaves(heads, state["params"])
    if not all(np.isfinite(losses)) or stale:
        raise AssertionError(f"lm_train/two_tower: losses {losses}, unchanged leaves {stale}")
    mlp = sum(a_ * b_ for t_ in ("user", "item")
              for a_, b_ in (w_.shape for w_ in (lp["w"] for lp in state["params"][t_]["mlp"])))
    flop = 3 * 2.0 * (TT_BATCH * mlp + TT_BATCH * TT_BATCH * cfg.tower_mlp[-1])
    times["two_tower_train_step_ms"] = step_ms[-1]
    say("lm_train", cell="two-tower-retrieval/train_batch", embed_dim=cfg.embed_dim,
        tower_mlp="-".join(map(str, cfg.tower_mlp)),
        cut=f"vocabularies {TT_ROWS} of 10M, batch {TT_BATCH} of 65536",
        tables_gb=f"{2 * TT_ROWS * cfg.embed_dim * 4 / 1e9:.2f}", build_s=f"{build_s:.2f}",
        step_ms="/".join(f"{x:.1f}" for x in step_ms), losses="/".join(f"{x:.6g}" for x in losses),
        examples_per_s=f"{TT_BATCH / step_ms[-1] * 1e3:.1f}",
        model_tflop=f"{flop / 1e12:.3f}", model_flop_share_of_989=rate(flop, step_ms[-1]),
        embedding_bag_launches_a_step=2,
        bag_user=f"B={idx.shape[0]} K={kb} distinct={n_rows}", bag_kernel_ms=f"{bag_ms:.4f}",
        bag_plain_ms=f"{bag_plain_ms:.4f}", bag_library_ms=f"{bag_lib_ms:.4f}",
        bag_bound_ms=f"{bag_bytes / HBM_BYTES_PER_S * 1e3:.4f}",
        bag_vs_plain=f"atol {bag_atol:.3e}",
        first_step_vs_plain_bag=(f"loss rtol {TT_RTOL}; table grad rows max diff "
                                 + "/".join(f"{e_:.3e}" for e_ in grad_err)),
        peak_gb=peak(resident), card=f"'{card}'", wall_s=f"{time.perf_counter() - c0:.1f}")
    del state, params, batch, heads, metrics, idx, rows
    torch.cuda.empty_cache()


def serve_phase(g, launches: dict, times: dict, dev, card: str) -> None:
    """The serve phase (see the module docstring).  ``g`` is the social
    DiGraph on the card; every level serves a clone of it, so ``g`` stays
    as it was.  Kernel launches add into ``launches``, times into
    ``times``."""
    from repro_torch.core import edgebatch, updates, walk_image
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.slot_walk import kernel as sw_kernel
    from repro_torch.kernels.slot_walk import ops as sw_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.runtime import faultinject
    from repro_torch.runtime import serve as serve_mod

    p0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = g.to_csr()  # generation 0 of every level
    nv = int(base.n)
    phase_launches = dict.fromkeys(KERNELS, 0)

    def check_level(name, srv, walks, upds, *, verify=SERVE_VERIFY):
        """The zero-lost ledger, then the sampled walks against the card
        oracle at their own generations; -> (stats, torn, checked)."""
        stats = srv.assert_no_lost()
        torn, checked = launch_serve.count_torn_reads(
            launch_serve.GenerationOracle(base), walks, upds, sample=verify,
            seed=SERVE_VERIFY_SEED)
        if torn or not checked:
            raise AssertionError(f"serve/{name}: {torn} torn reads of {checked} checked")
        return stats, torn, checked

    def level(name, *, requests, submit_gap_s, timeout, max_queue, fault=None):
        """bench_serve's ``_serve_row`` on a clone of ``g``: warm-up (3
        insertion updates, a batch of walks), then the traffic."""
        srv = serve_mod.WalkServer(g.clone(), max_queue=max_queue, batch_max=SERVE_BATCH,
                                   default_timeout=timeout).start()
        try:
            wrng = np.random.default_rng(99)
            warm_upds = []
            for _ in range(3):
                plan = updates.plan_update(
                    inserts=edgebatch.random_insertions(wrng, nv, SERVE_UPDATE_SIZE))
                warm_upds.append((srv.submit_update(plan), plan))
            warm = [srv.submit_walk([1, 2], steps=SERVE_STEPS) for _ in range(SERVE_BATCH)]
            for t in [u for u, _ in warm_upds] + warm:
                if not t.wait(120.0):
                    raise AssertionError(f"serve/{name}: a warm-up ticket is still pending")
            if fault:
                faultinject.arm(fault, times=2)
            t0 = time.monotonic()
            walks, upds = launch_serve.run_traffic(
                srv, nv, requests=requests, steps=SERVE_STEPS,
                seeds_per_request=SERVE_SEEDS, update_every=SERVE_UPDATE_EVERY,
                update_size=SERVE_UPDATE_SIZE, seed=SERVE_SEED, submit_gap_s=submit_gap_s,
                timeout=timeout)
            for t in walks:
                if not t.wait(120.0):
                    raise AssertionError(f"serve/{name}: a walk ticket is still pending")
            wall = time.monotonic() - t0
            fired = faultinject.fired(fault) if fault else 0
        finally:
            srv.stop(timeout=120.0)
            faultinject.disarm()
        stats, torn, checked = check_level(name, srv, warm + walks, warm_upds + upds)
        served = [t for t in walks if t.status == serve_mod.SERVED]
        pct = launch_serve.percentiles([t.latency_s for t in served])
        acks = [u.resolved_at - u.submitted_at for u, _ in upds if u.status == serve_mod.SERVED]
        ack = launch_serve.percentiles(acks)
        say("serve", card=card, level=name, requests=requests, served=len(served),
            submitted=stats["submitted"], shed_expired=stats["shed_expired"],
            rejected=stats["rejected_backpressure"] + stats["rejected_other"],
            failed=stats["failed"], lost=0, batches=stats["batches"],
            max_batch=stats["max_batch"], seals=stats["seals"],
            updates=stats["updates_applied"], dispatch_retries=stats["dispatch_retries"],
            breaker_fallbacks=stats["breaker_fallbacks"], fault=fault or "none",
            fired=fired, **{k_: f"{v_:.2f}" for k_, v_ in pct.items()},
            ack_p50_ms=f"{ack['p50_ms']:.2f}", ack_p99_ms=f"{ack['p99_ms']:.2f}",
            req_per_s=f"{len(served) / wall:.1f}", wall_s=f"{wall:.2f}",
            torn_reads=torn, torn_checked=checked)
        return srv, stats, served, pct, ack, wall

    try:
        with count_calls(sw_kernel, ("tile_cumsum_torch", "slot_gather_torch")) as plain, \
                counted(KERNELS, phase_launches), \
                timed_calls(walk_image, "seal_generation") as seals:
            srv, _, served, pct, ack, wall = level("steady", **SERVE_LEVELS["steady"])
            times["walk_serve_p50_ms"] = pct["p50_ms"]
            times["walk_serve_p99_ms"] = pct["p99_ms"]
            times["walk_serve_req_per_s"] = len(served) / wall
            times["walk_serve_ack_p99_ms"] = ack["p99_ms"]
            seal_ms = [h_ * 1e3 for _, _, h_ in seals]
            times["walk_serve_seal_ms"] = float(np.median(seal_ms))
            gen_img = srv.generation.image
            del srv, served

            _, _, _, pct, _, _ = level("overload", **SERVE_LEVELS["overload"])
            times["walk_serve_overload_p99_ms"] = pct["p99_ms"]

            _, stats, _, _, _, _ = level("fault", fault="slot_walk.cuda",
                                         **SERVE_LEVELS["fault"])
            if stats["dispatch_retries"] < 1 or stats["failed"]:
                raise AssertionError(f"serve/fault: {stats['dispatch_retries']} retries, "
                                     f"{stats['failed']} failed")

            # a persistent kernel-site fault: the ticket fails visibly, and
            # the server serves again once the fault clears
            srv = serve_mod.WalkServer(g.clone(), batch_max=SERVE_BATCH).start()
            try:
                faultinject.arm("slot_walk.cuda", times=10**6)
                dead = srv.submit_walk([1, 2, 3, 4], steps=SERVE_STEPS)
                if not dead.wait(120.0):
                    raise AssertionError("serve/persistent: the ticket is still pending")
                fired = faultinject.fired("slot_walk.cuda")
                faultinject.disarm()
                alive = srv.submit_walk([1, 2, 3, 4], steps=SERVE_STEPS)
                if not alive.wait(120.0):
                    raise AssertionError("serve/persistent: the later ticket is still pending")
            finally:
                srv.stop(timeout=120.0)
                faultinject.disarm()
            stats, torn, checked = check_level("persistent", srv, [dead, alive], [],
                                               verify=1.0)
            if dead.status != serve_mod.FAILED or alive.status != serve_mod.SERVED \
                    or stats["failed"] != 1 or fired != srv.dispatch_retries + 1:
                raise AssertionError(f"serve/persistent: {dead.status}, {alive.status}, "
                                     f"{stats['failed']} failed, fired {fired}")
            say("serve", card=card, level="persistent", fault="slot_walk.cuda",
                fired=fired, dead=dead.status, error=type(dead.error).__name__,
                later=alive.status, failed=stats["failed"],
                dispatch_retries=stats["dispatch_retries"], torn_reads=torn,
                torn_checked=checked)

            # serve.seal armed once: while the writer waits to retry the
            # seal, a reader is served the previous generation, which the
            # writer's apply copied before it wrote (copy-on-write)
            rep = g.clone()
            srv = serve_mod.WalkServer(rep, batch_max=SERVE_BATCH,
                                       retry_backoff=SERVE_SEAL_BACKOFF_S).start()
            seeds = [1, 2, 3, 4]
            srng = np.random.default_rng(SERVE_SEED)
            plan = updates.plan_update(inserts=edgebatch.from_arrays(  # edges into the seeds
                srng.integers(0, nv, SERVE_UPDATE_SIZE), np.resize(seeds, SERVE_UPDATE_SIZE)))
            gen0 = srv.generation
            sums0 = [checksum(t_) for t_ in (gen0.image.dst, gen0.image.wgt)]
            try:
                faultinject.arm("serve.seal", times=1)
                ut = srv.submit_update(plan)
                deadline = time.monotonic() + 60.0
                while srv.stats()["seal_failures"] < 1 and time.monotonic() < deadline:
                    time.sleep(0.001)
                before = srv.submit_walk(seeds, steps=SERVE_STEPS)
                if not before.wait(60.0) or not ut.wait(60.0):
                    raise AssertionError("serve/seal: a ticket is still pending")
                after = srv.submit_walk(seeds, steps=SERVE_STEPS)
                if not after.wait(60.0):
                    raise AssertionError("serve/seal: a ticket is still pending")
            finally:
                srv.stop(timeout=120.0)
                faultinject.disarm()
            stats, torn, checked = check_level("seal", srv, [before, after], [(ut, plan)],
                                               verify=1.0)
            copied = gen0.image.dst.data_ptr() != rep.dst.data_ptr()
            unchanged = sums0 == [checksum(t_) for t_ in (gen0.image.dst, gen0.image.wgt)]
            if (stats["seal_failures"] < 1 or (before.generation, ut.generation,
                                              after.generation) != (0, 1, 1)
                    or before.resolved_at >= ut.resolved_at or not copied or not unchanged
                    or torch.equal(before.visits, after.visits)):
                raise AssertionError(
                    f"serve/seal: failures {stats['seal_failures']}, generations "
                    f"{before.generation}/{ut.generation}/{after.generation}, "
                    f"copied {copied}, generation 0 unchanged {unchanged}")
            say("serve", card=card, level="seal", fault="serve.seal", times=1,
                seal_failures=stats["seal_failures"], reader_generation=before.generation,
                update_ack_generation=ut.generation, later_generation=after.generation,
                writer_copied_before_writing=copied, generation0_checksums="unchanged",
                torn_reads=torn, torn_checked=checked)
            del rep, srv, gen0
        if any(plain.values()):
            raise AssertionError(f"serve: the plain tile cumsum or gather ran {plain} times")
        for k_ in ("tile_cumsum", "merge_rows_fused"):
            if phase_launches[k_] == 0:
                raise AssertionError(f"serve: {k_} never launched")
        for k_, v_ in phase_launches.items():
            launches[k_] += v_
        serving_peak = torch.cuda.max_memory_allocated()

        # one B = 16 batch on the steady level's last generation, and the
        # batched tile_cumsum it launches, against its plain version
        srng = np.random.default_rng(SERVE_VERIFY_SEED)
        v0 = torch.stack([launch_serve.seed_visits_row(nv, srng.integers(0, nv, SERVE_SEEDS),
                                                       device=dev)
                          for _ in range(SERVE_BATCH)])
        times["walk_serve_batch_event_ms"] = time_ms(
            lambda: gen_img.walk(SERVE_STEPS, visits0=v0), reps=5)
        gidx = sw_ops._prep_gidx(gen_img.dst, nv, gen_img.edges_hi())
        vals = torch.cat([v0, v0.new_zeros(SERVE_BATCH, 1)], 1).index_select(
            1, gidx.reshape(-1)).reshape(-1, sw_kernel.EB)
        del gidx
        got = sw_kernel.tile_cumsum(vals)
        ref = sw_kernel.tile_cumsum_torch(vals)
        err = (got - ref).abs()
        if not bool((err <= 1e-5 * ref.abs() + 1e-6 * ref.abs().amax(dim=1, keepdim=True)).all()):
            raise AssertionError("serve: batched tile_cumsum disagrees with its plain version")
        max_err = float(err.max())
        del got, ref, err
        nbytes = vals.numel() * 4 * 2
        cum = dict(ms=time_ms(lambda: sw_kernel.tile_cumsum(vals), reps=10),
                   plain_ms=time_ms(lambda: sw_kernel.tile_cumsum_torch(vals), reps=3),
                   library_ms=time_ms(lambda: torch.cumsum(vals, dim=-1), reps=3),
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        say("serve", card=card, batched_tile_cumsum=f"[{vals.shape[0]},{vals.shape[1]}]",
            bytes=nbytes, max_abs_err=max_err, tolerance="rtol 1e-5, atol 1e-6*tile max",
            **{k_: f"{v_:.4f}" for k_, v_ in cum.items()},
            batch_event_ms=f"{times['walk_serve_batch_event_ms']:.4f}")
        del vals, v0, gen_img
        torch.cuda.empty_cache()
        say("serve", card=card, steady_seals=len(seal_ms),
            seal_ms="/".join(f"{x_:.1f}" for x_ in seal_ms),
            launches="/".join(f"{k_}={v_}" for k_, v_ in phase_launches.items() if v_),
            plain_tile_cumsum_calls=0, serving_peak_gb=f"{serving_peak / 1e9:.2f}",
            phase_peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            phase_s=f"{time.perf_counter() - p0:.1f}")
    finally:
        faultinject.disarm()


# ---------------------------------------------------------------------------
# model_shard: model sharding over a DeviceMesh
# ---------------------------------------------------------------------------
def tt_table_rows(tower: int, lo: int, hi: int, dev) -> torch.Tensor:
    """Rows [lo, hi) of the model_shard two-tower cell's table ``tower`` (0
    the users', 1 the items'): N(0,1)·0.01, as ``two_tower.init_params``
    draws a table, in blocks of TT_DRAW_ROWS rows, block ``b`` from a
    generator seeded SEED + 1 + 2b + tower."""
    from repro_torch.configs import two_tower_retrieval

    d = two_tower_retrieval.FULL.embed_dim
    out = torch.empty((hi - lo, d), dtype=torch.float32, device=dev)
    for b in range(lo // TT_DRAW_ROWS, -(-hi // TT_DRAW_ROWS)):
        b0 = b * TT_DRAW_ROWS
        gen = torch.Generator(device=dev).manual_seed(SEED + 1 + 2 * b + tower)
        block = torch.randn((min(TT_DRAW_ROWS, SHARD_TT_ROWS - b0), d), generator=gen,
                            dtype=torch.float32, device=dev).mul_(0.01)
        s0, s1 = max(lo, b0), min(hi, b0 + block.shape[0])
        out[s0 - lo:s1 - lo] = block[s0 - b0:s1 - b0]
    return out


def shard_cell_program(name: str, dev, data_axes: tuple, own_rows: bool = False):
    """The model_shard phase's cell ``name`` on ``dev`` (concrete, or fakes
    under a ``FakeTensorMode``), drawn from SEED, its config carrying
    ``data_axes``' sharding axes and its kernel sites on the kernels:
    (cell, arch, shape, the kernel its path must launch or None).  With
    ``own_rows``, two-tower's tables (and so their moments) are meta
    tensors, for each rank to make its own rows (``own_table_rows``)."""
    from repro_torch.configs import two_tower_retrieval
    from repro_torch.core import tree
    from repro_torch.launch import steps
    from repro_torch.models.recsys import two_tower
    from repro_torch.models.transformer import model as tm
    from repro_torch.train import loop as train_loop

    # a float32 cell's step hands its grads to ``grad_hook["fn"]`` (when set)
    # before the update: the phase holds the first step's grads
    hook = {"fn": None}

    def seen(grads):
        return grads if hook["fn"] is None else hook["fn"](grads)

    if name == "gcn":
        cell = steps.build_cell("gcn-cora", "ogb_products", device=dev, seed=SEED,
                                data_axes=data_axes)
        cfg = dataclasses.replace(cell.meta["cfg"], backend="cuda")
        cell.step_fn = train_loop.make_train_step(
            lambda p, b: cell.meta["module"].loss_fn(p, b, cfg), steps.OPT_CFG,
            compress_fn=seen)
        cell.meta["grad_hook"] = hook
        return cell, "gcn-cora", "ogb_products", "edge_segment_runs"
    if name == "two_tower":
        cfg = dataclasses.replace(two_tower_retrieval.FULL, n_users=SHARD_TT_ROWS,
                                  n_items=SHARD_TT_ROWS, backend="cuda",
                                  shard_axes=tuple(data_axes))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        # the towers' MLPs from ``gen``, the tables in seeded row blocks
        params = two_tower.init_params(dataclasses.replace(cfg, n_users=1, n_items=1),
                                       generator=gen, device=dev)
        for t_, tower in enumerate(("user", "item")):
            params[tower]["table"] = (
                torch.empty((SHARD_TT_ROWS, cfg.embed_dim), dtype=torch.float32, device="meta")
                if own_rows else tt_table_rows(t_, 0, SHARD_TT_ROWS, dev))
        state = train_loop.init_state(tree.tree_map(lambda p: p.requires_grad_(), params),
                                      steps.OPT_CFG)

        def bags(nf):
            return torch.randint(-1, SHARD_TT_ROWS, (TT_BATCH, nf, cfg.bag_size),
                                 generator=gen, device=dev, dtype=torch.int32)

        batch = {"user_bags": bags(cfg.n_user_fields), "item_bags": bags(cfg.n_item_fields),
                 "item_logq": torch.zeros((TT_BATCH,), dtype=torch.float32, device=dev)}
        step = train_loop.make_train_step(lambda p, b: two_tower.loss_fn(p, b, cfg),
                                          steps.OPT_CFG, compress_fn=seen)
        cell = steps.CellProgram(step_fn=step, args=(state, batch),
                                 meta={"cfg": cfg, "grad_hook": hook},
                                 loop_correction={"kind": "recsys"})
        return cell, "two-tower-retrieval", "train_batch", "embedding_bag"
    if name == "train":
        cell = steps.build_cell("h2o-danube-1.8b", "train_4k", variant="cost2", device=dev,
                                seed=SEED, data_axes=data_axes)
        state, full = cell.args
        batch = {k_: v_[:H2O_ACCUM * H2O_UB].reshape(H2O_ACCUM, H2O_UB, -1)
                 for k_, v_ in full.items()}
        cfg = dataclasses.replace(cell.meta["cfg"], backend="cuda")
        cell.step_fn = train_loop.make_train_step(lambda p, b: tm.loss_fn(p, b, cfg),
                                                  cell.meta["opt_cfg"], grad_accum=H2O_ACCUM)
        cell.args = (state, batch)
        return cell, "h2o-danube-1.8b", "train_4k", None
    if name == "sampled":
        cell = steps.build_cell("gcn-cora", "minibatch_lg", device=dev, seed=SEED,
                                data_axes=data_axes)
        cfg = dataclasses.replace(cell.meta["cfg"], backend="cuda")
        loss_fn = cell.meta["module"].loss_fn  # not ``cell``: the ranks free the drawn batch
        inner = train_loop.make_train_step(lambda p, b: loss_fn(p, b, cfg), steps.OPT_CFG,
                                           compress_fn=seen)
        graph = cell.meta["graph"]
        cell.step_fn = lambda state, batch: inner(state, graph(batch))
        cell.meta["grad_hook"] = hook
        return cell, "gcn-cora", "minibatch_lg", "edge_segment_runs"
    if name == "decode":
        cell = steps.build_cell("h2o-danube-1.8b", "decode_32k", variant="cost2", device=dev,
                                seed=SEED, data_axes=data_axes)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        for buf in (cell.args[1]["k"], cell.args[1]["v"]):  # every slot holds K/V
            buf.normal_(generator=gen)
        return cell, "h2o-danube-1.8b", "decode_32k", None
    cell = steps.build_cell("h2o-danube-1.8b", "prefill_32k", variant="cost2", device=dev,
                            seed=SEED, data_axes=data_axes)
    cell.args = (cell.args[0], cell.args[1][:PREFILL_BATCH])
    cell.step_fn = cell.meta["make_step"]("cuda", attn_impl="flash")
    return cell, "h2o-danube-1.8b", "prefill_32k", "flash_attention"


def decode_refs(cell, root: str) -> dict:
    """The decode cell unsharded (bfloat16 compute) through the ranks' steps
    (a warm-up and SHARD_DECODE_POSITIONS), each timed step beside a
    float32-compute step on a copy of the cache as it stood: the float32
    logits and both written slots ([L, B, Hkv, Dh]) written under ``root``
    (``decode_<j>.pt``) -> the bf16 logits' RMS distance from the f32 ones
    a step."""
    params, cache, toks = cell.args
    step16 = cell.step_fn
    step32 = cell.meta["make_step"](compute_dtype=torch.float32)
    pos = SHARD_DECODE_POSITIONS
    step16(params, {**cache, "pos": pos[0]}, toks)  # the ranks' warm-up
    rms = []
    for j, p_ in enumerate(pos):
        twin = {k_: cache[k_].clone() for k_ in ("k", "v")}
        l32 = step32(params, {**twin, "pos": p_}, toks)[0].float()
        l16 = step16(params, {**cache, "pos": p_}, toks)[0]
        slot = p_ % cache["k"].shape[3]
        torch.save({"logits32": l32.cpu(),
                    "slot32": {k_: twin[k_][:, :, :, slot].cpu() for k_ in twin},
                    "slot16": {k_: cache[k_][:, :, :, slot].cpu() for k_ in twin}},
                   os.path.join(root, f"decode_{j}.pt"))
        rms.append(float(torch.sqrt(torch.mean((l16.float() - l32) ** 2))))
        del twin, l32, l16
    return {"plain_rms": rms, "slot_numel": 2 * cache["k"][:, :, :, 0].numel()}


def shard_refs(root: str) -> dict:
    """The model_shard cells run unsharded on the card from the same seed
    (the same two steps and the sampled cell's subgraph; the prefill's
    logits through the plain attention in float32 and in bfloat16; the
    decode steps, ``decode_refs``), written under ``root`` for the ranks,
    in a process of its own (its memory goes with it): -> each cell's
    losses and the prefill's and decode steps' bf16 RMS distances from
    float32."""
    from repro_torch.core import tree

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for name in SHARD_CELLS:
        torch.cuda.empty_cache()
        cell, *_ = shard_cell_program(name, dev, ())
        if name == "decode":
            out[name] = decode_refs(cell, root)
        elif name == "prefill":
            params, toks = cell.args
            ref32 = cell.meta["make_step"]("torch", attn_impl="flash",
                                           compute_dtype=torch.float32)(params, toks).float()
            plain16 = cell.meta["make_step"]("torch", attn_impl="flash")(params, toks)
            out[name] = {"plain_rms": float(
                torch.sqrt(torch.mean((plain16.float() - ref32) ** 2)))}
            torch.save(ref32.cpu(), os.path.join(root, f"{name}.pt"))
            del params, toks, ref32, plain16
        else:
            if name in SHARD_F32_LIMITS:  # the first step's grads, at the drawn weights
                def keep(grads):
                    torch.save({k: v.detach().cpu() for k, v in tree.paths(grads)},
                               os.path.join(root, f"{name}_grads.pt"))
                    out[name] = {"grad_max": {k: float(v.abs().max())
                                              for k, v in tree.paths(grads)}}
                    cell.meta["grad_hook"]["fn"] = None
                    return grads
                cell.meta["grad_hook"]["fn"] = keep
            if name == "sampled":  # the subgraph, for the ranks' gathered one
                torch.save({k: v.cpu() for k, v in cell.meta["graph"](cell.args[1]).items()
                            if isinstance(v, torch.Tensor)},
                           os.path.join(root, "sampled_subgraph.pt"))
            losses = [float(cell.step_fn(*cell.args)[1]["loss"]) for _ in range(2)]
            torch.save({k: v.detach().cpu() for k, v in tree.paths(cell.args[0]["params"])},
                       os.path.join(root, f"{name}.pt"))
            out.setdefault(name, {})["losses"] = losses
        del cell
    torch.cuda.empty_cache()
    return out


def own_table_rows(state: dict, dev) -> dict:
    """The sharded two-tower state with each meta leaf made on this rank:
    its rows of each table drawn (``tt_table_rows``), zeros for their
    moments."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core import tree

    leaves = []
    for path, d in tree.paths(state):
        if isinstance(d, DTensor) and d.to_local().is_meta:
            rows = local_slices(d)[0]
            local = (tt_table_rows(0 if path.startswith("params/user/") else 1,
                                   rows.start, rows.stop, dev)
                     if path.startswith("params/") else
                     torch.zeros(d.to_local().shape, dtype=d.dtype, device=dev))
            d = DTensor.from_local(local, d.device_mesh, d.placements, run_check=False,
                                   shape=d.shape, stride=d.stride()
                                   ).requires_grad_(d.requires_grad)
        leaves.append(d)
    return tree.unflatten(state, leaves)


def local_slices(d) -> tuple:
    """The global index slices of this rank's shard of DTensor ``d``."""
    from repro_torch.models import sharding_utils as su

    local = d.to_local()
    return tuple(slice(su.local_offset(d, i), su.local_offset(d, i) + local.shape[i])
                 if any(p.is_shard(i) for p in d.placements) else slice(None)
                 for i in range(d.ndim))


def hold_shard(d, ref_cpu, rtol: float, atol: float, before=None,
               chunk: int = 1 << 24) -> dict:
    """This rank's shard of ``d`` against the same slice of the unsharded
    ``ref_cpu``, in row chunks: the largest |difference|, the elements
    outside ``atol + rtol*|ref|``, the squared difference and the squared
    reference summed, and (given the shard ``before`` the steps) the
    reference's squared change summed."""
    local = d.to_local().detach()
    width = local.shape[-1] if local.ndim else 1
    local = local.reshape(-1, width)  # rows of the leading dims, in chunks
    ref = ref_cpu[local_slices(d)].reshape(-1, width)
    if before is not None:
        before = before.reshape(-1, width)
    rows = max(chunk // width, 1)
    worst, bad, sq, sq_ref, sq_step = 0.0, 0, 0.0, 0.0, 0.0
    for i in range(0, local.shape[0], rows):
        a = local[i:i + rows].float()
        b = ref[i:i + rows].to(a.device).float()
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        bad += int((diff > atol + rtol * b.abs()).sum())
        sq += float((diff.double() ** 2).sum())
        sq_ref += float((b.double() ** 2).sum())
        if before is not None:
            sq_step += float(((b - before[i:i + rows].float()).double() ** 2).sum())
    return {"max_abs": worst, "bad": bad, "sq": sq, "sq_ref": sq_ref, "sq_step": sq_step,
            "n": local.numel()}


def model_shard_rank(rank_mesh, root: str, grad_max: dict) -> dict:
    """One rank of the model_shard phase, in its own process: each cell
    built on a (2, 2) ("data", "model") DeviceMesh of the 4 ranks (each rank
    draws the full cell from the seed in turn and keeps its shards), a
    warm-up step and a timed step (CUDA events; kernel launches, collectives
    and the flops counted), then the parameters (or the prefill's logits)
    held shard by shard against the unsharded run's files under ``root``."""
    from repro_torch.launch import mesh as mesh_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh_mod.use_c10d_all_gather()
    dm = mesh_mod.make_mesh_like(SHARD_MESH, SHARD_AXES, device_type="cuda")
    out = {"rank": rank_mesh.rank, "coord": dm.get_coordinate(), "cells": {}}
    for name in SHARD_CELLS:
        out["cells"][name] = model_shard_cell(rank_mesh, dm, name, root,
                                              grad_max.get(name, {}))
        torch.cuda.empty_cache()
    return out


def model_shard_cell(rank_mesh, dm, name: str, root: str, grad_max: dict) -> dict:
    """One cell on one rank of the model_shard phase: its record.  The float32
    cells' warm-up grads (at the drawn weights) are held shard by shard
    against the unsharded run's within rtol 1e-4 and 1e-6 of each leaf's
    max|grad|."""
    import torch.distributed as tdist

    from repro_torch.core import tree
    from repro_torch.train import optimizer as opt_mod

    from repro_torch.kernels import KERNELS
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as mesh_mod

    dev, rank = rank_mesh.device, rank_mesh.rank
    t0 = time.perf_counter()
    cell, arch, shape, kernel = shard_cell_program(name, dev, mesh_mod.data_axes(dm),
                                                   own_rows=True)
    sharded = steps.shard_cell(cell, steps.attach_shardings(cell, dm, arch, shape), dm)
    del cell
    if name == "two_tower":
        sharded.args = (own_table_rows(sharded.args[0], dev), sharded.args[1])
    gc.collect()  # the drawn cell (its step's closures hold it in a cycle)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    say("model_shard_build", cell=name, rank=rank, build_s=f"{time.perf_counter() - t0:.2f}",
        allocated_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}",
        card_free_gb=f"{torch.cuda.mem_get_info()[0] / 1e9:.2f}")
    tdist.barrier()
    rec = {"argument_bytes": dryrun.arg_bytes(sharded.args)}
    if name == "decode":
        rec.update(model_shard_decode(sharded, root))
        return rec
    if name == "sampled":
        rec["subgraph"], rec["subgraph_placements"] = hold_subgraph(sharded, dm, root)
    if name in SHARD_F32_LIMITS:
        def hold(grads):  # the warm-up step's grads, placed as their parameters
            params = sharded.args[0]["params"]
            grads = tree.tree_map(opt_mod.follow, grads, params)
            ref = torch.load(os.path.join(root, f"{name}_grads.pt"), mmap=True)
            rec["grads"] = {k_: hold_shard(g_, ref[k_], 1e-4, 1e-6 * grad_max[k_])
                            for k_, g_ in tree.paths(grads)}
            sharded.meta["grad_hook"]["fn"] = None
            return grads
        sharded.meta["grad_hook"]["fn"] = hold
    before = ({k_: v_.to_local().detach().clone()
               for k_, v_ in tree.paths(sharded.args[0]["params"])}
              if name != "prefill" else {})
    torch.cuda.reset_peak_memory_stats()
    sharded.step_fn(*sharded.args)  # warm-up
    phase = dict.fromkeys(KERNELS, 0)
    ev = event_pair()
    tdist.barrier()
    with counted(KERNELS, phase), dryrun.LocalCounter() as counter:
        ev[0].record()
        got = sharded.step_fn(*sharded.args)
        ev[1].record()
    torch.cuda.synchronize()
    rec.update(step_ms=ev[0].elapsed_time(ev[1]),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches={k_: v_ for k_, v_ in phase.items() if v_},
               collectives=counter.collectives(), flops=counter.flops)
    if kernel is not None and phase[kernel] == 0:
        raise AssertionError(f"model_shard/{name} rank {rank}: {kernel} never launched")
    ref = torch.load(os.path.join(root, f"{name}.pt"), mmap=True)
    if name == "prefill":
        rec["logits"] = hold_shard(got, ref, 0.0, float("inf"))
        del got
        # the same sharded model through the plain attention: the bound's twin
        plain = sharded.meta["make_step"]("torch", attn_impl="flash")(*sharded.args)
        rec["logits_plain"] = hold_shard(plain, ref, 0.0, float("inf"))
    else:
        rec["loss"] = float(got[1]["loss"])
        tol = (1e-5, 1e-6) if name != "train" else (0.0, float("inf"))
        rec["params"] = {k_: hold_shard(v_, ref[k_], *tol, before=before[k_])
                         for k_, v_ in tree.paths(got[0]["params"])}
    return rec


def hold_subgraph(sharded, dm, root: str) -> tuple:
    """The sampled cell's subgraph on this rank (the sampler on the mesh,
    its picks gathered, each subgraph tensor placed over every axis):
    every tensor's shard against the unsharded run's, bit for bit (ids
    below 2^24 compare exactly as float32) -> (``hold_shard``'s records,
    the edges' placements)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import sharding_utils as su

    with su.use_mesh(dm), implicit_replication():
        sub = sharded.meta["graph"](sharded.args[1])
    ref = torch.load(os.path.join(root, "sampled_subgraph.pt"), mmap=True)
    if sorted(ref) != sorted(k_ for k_, v_ in sub.items() if isinstance(v_, torch.Tensor)):
        raise AssertionError(f"model_shard/sampled: subgraph keys {sorted(sub)} vs {sorted(ref)}")
    out = {}
    for k_, v_ in ref.items():
        d = sub[k_]
        if not su.is_dtensor(d) or d.dtype != v_.dtype or tuple(d.shape) != tuple(v_.shape):
            raise AssertionError(f"model_shard/sampled: subgraph {k_} is {type(d).__name__} "
                                 f"{d.dtype} {tuple(d.shape)}, the unsharded {v_.dtype} "
                                 f"{tuple(v_.shape)}")
        out[k_] = hold_shard(d, v_, 0.0, 0.0)
    return out, str(tuple(sub["edge_dst"].placements))


def model_shard_decode(sharded, root: str) -> dict:
    """The decode cell's steps on this rank: a warm-up at the first of
    SHARD_DECODE_POSITIONS, then a timed step at each (CUDA events; the
    first counted by ``LocalCounter``, as the dry run's one step).  Held
    after each against ``decode_refs``' files: the logits' shard (its
    squared distance from the float32 logits), and on the rank whose
    sequence slice holds the step's slot, that slot's batch shard (its
    squared distance from the float32 step's slot, the unsharded bf16
    step's own, and its elements bit-equal to the unsharded bf16 slot);
    after both, every other slot of this rank's slice bit for bit as drawn."""
    import torch.distributed as tdist

    from repro_torch.kernels import KERNELS
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding_utils as su

    params, cache, toks = sharded.args
    init = {k_: cache[k_].to_local().clone() for k_ in ("k", "v")}
    s_lo, b_lo = su.local_offset(cache["k"], 3), su.local_offset(cache["k"], 1)
    s_n, b_n = init["k"].shape[3], init["k"].shape[1]
    ring = cache["k"].shape[3]
    torch.cuda.reset_peak_memory_stats()
    sharded.step_fn(params, {**cache, "pos": SHARD_DECODE_POSITIONS[0]}, toks)  # warm-up
    phase = dict.fromkeys(KERNELS, 0)
    rec = {"steps": [], "owned_slots": []}
    for j, p_ in enumerate(SHARD_DECODE_POSITIONS):
        ev = event_pair()
        tdist.barrier()
        counter = dryrun.LocalCounter() if j == 0 else contextlib.nullcontext()
        with counted(KERNELS, phase), counter:
            ev[0].record()
            logits, cache = sharded.step_fn(params, {**cache, "pos": p_}, toks)
            ev[1].record()
        torch.cuda.synchronize()
        if j == 0:
            rec.update(collectives=counter.collectives(), flops=counter.flops)
        ref = torch.load(os.path.join(root, f"decode_{j}.pt"), mmap=True)
        step = {"ms": ev[0].elapsed_time(ev[1]),
                "logits": hold_shard(logits, ref["logits32"], 0.0, float("inf"))}
        slot = p_ % ring
        if s_lo <= slot < s_lo + s_n:
            rec["owned_slots"].append(slot)
            sq = sq16 = same = n = 0.0
            for k_ in ("k", "v"):
                mine = cache[k_].to_local()[:, :, :, slot - s_lo].float()
                r32 = ref["slot32"][k_][:, b_lo:b_lo + b_n].to(mine.device).float()
                r16 = ref["slot16"][k_][:, b_lo:b_lo + b_n].to(mine.device).float()
                sq += float(((mine - r32).double() ** 2).sum())
                sq16 += float(((r16 - r32).double() ** 2).sum())
                same += int((mine == r16).sum())
                n += mine.numel()
            step["slot"] = {"sq": sq, "sq16": sq16, "same": same, "n": n}
        rec["steps"].append(step)
    bad = 0
    for k_ in ("k", "v"):
        keep = [i_ for i_ in range(s_n) if s_lo + i_ not in
                {p_ % ring for p_ in SHARD_DECODE_POSITIONS}]
        now = cache[k_].to_local()
        bad += int((now[:, :, :, keep] != init[k_][:, :, :, keep]).sum())
    rec.update(step_ms=rec["steps"][0]["ms"], short_step_ms=rec["steps"][1]["ms"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, unwritten_changed=bad,
               launches={k_: v_ for k_, v_ in phase.items() if v_},
               placements=str(tuple(cache["k"].placements)))
    return rec


def model_shard_dryrun(which: str, root: str) -> list:
    """The dry run in its own process (a fake process group: each call of
    the phase gets a fresh one).  ``"mesh"``: the phase's cells on a fake
    (2, 2) mesh of fake CUDA tensors -> their records.  ``"production"``:
    h2o-danube-1.8b x train_4k at cost2/cost4/opt1/opt2 and mace x
    ogb_products at chunk2/chunk4 on the 16x16 mesh -> the records' trace
    seconds and the two cells' roofline terms (launch.roofline), the records
    written under ``root``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun, roofline, steps
    from repro_torch.launch import mesh as mesh_mod

    if which == "mesh":
        dryrun.init_fake_world(int(np.prod(SHARD_MESH)))
        mesh = mesh_mod.make_mesh_like(SHARD_MESH, SHARD_AXES, device_type="cuda")
        recs = []
        for name in SHARD_CELLS:
            with FakeTensorMode():
                cell, arch, shape, _ = shard_cell_program(name, torch.device("cuda"),
                                                          mesh_mod.data_axes(mesh))
                recs.append(dryrun.step_record(
                    cell, steps.attach_shardings(cell, mesh, arch, shape), mesh))
        return recs
    dryrun.init_fake_world(256)
    mesh = mesh_mod.make_production_mesh(device_type="cuda")
    rows = []
    roofline.RESULTS_DIR = root
    for arch, shape, variants in SHARD_ROOFLINE:
        lc = full = None
        for v in variants:
            rec = dryrun.run_cell(arch, shape, mesh=mesh, variant=v)
            if rec["status"] != "ok":
                raise AssertionError(f"model_shard/dryrun {arch} {shape} {v}: "
                                     f"{rec.get('error')}")
            with open(dryrun.result_path(arch, shape, v, False, root=root), "w") as f:
                json.dump(rec, f)
            lc = lc or (rec["loop_correction"] if not v.startswith("opt") else None)
            if v == "full":
                full = rec
            rows.append({"arch": arch, "shape": shape, "variant": v,
                         "trace_s": rec["trace_s"],
                         "peak_gb": f"{rec['memory']['peak_bytes'] / 1e9:.3f}",
                         "flops": f"{rec['cost']['flops']:.4e}"})
        step = roofline.costs_from(arch, shape, lc, full)
        rows.append({"arch": arch, "shape": shape, **roofline.terms(arch, shape, step)})
    return rows


def hold_decode(recs: list, ref: dict, line: dict, failed: list) -> None:
    """The decode cell's checks over its ranks' records (rank order), into
    ``line`` and ``failed``: for each timed step, the logits' RMS distance
    from the unsharded float32 decode at most LM_BF16_RMS_RATIO x the
    unsharded bf16 decode's (ROADMAP.md section 3's bf16 standard; every
    rank holds a distinct shard), and the written slot's the same against
    the unsharded bf16 step's (its bit-equal share beside it); no other slot
    changed on any rank."""
    for j, p_ in enumerate(SHARD_DECODE_POSITIONS):
        steps_ = [r_["steps"][j] for r_ in recs]
        rms = float(np.sqrt(sum(s_["logits"]["sq"] for s_ in steps_)
                            / sum(s_["logits"]["n"] for s_ in steps_)))
        base = ref["plain_rms"][j]
        slots = [s_["slot"] for s_ in steps_ if "slot" in s_]
        n = sum(s_["n"] for s_ in slots)
        slot_rms = float(np.sqrt(sum(s_["sq"] for s_ in slots) / n))
        slot_base = float(np.sqrt(sum(s_["sq16"] for s_ in slots) / n))
        tag = f"pos{p_}"
        line.update({f"{tag}_rms_vs_f32": f"{rms:.4e}", f"{tag}_unsharded_rms_vs_f32": f"{base:.4e}",
                     f"{tag}_ratio": f"{rms / base:.4f}" if base else "inf",
                     f"{tag}_slot_rms_vs_f32": f"{slot_rms:.4e}",
                     f"{tag}_slot_unsharded_rms_vs_f32": f"{slot_base:.4e}",
                     f"{tag}_slot_bit_equal_share": f"{sum(s_['same'] for s_ in slots) / n:.4f}",
                     f"{tag}_slot_owners": sum(1 for s_ in steps_ if "slot" in s_)})
        if not rms <= LM_BF16_RMS_RATIO * base:
            failed.append(f"model_shard/decode pos {p_}: logits' RMS distance {rms} from the "
                          f"f32 decode exceeds {LM_BF16_RMS_RATIO} x the unsharded bf16's {base}")
        if n != ref["slot_numel"] or not slot_rms <= LM_BF16_RMS_RATIO * slot_base:
            failed.append(f"model_shard/decode pos {p_}: written slot ({n} elements held) at "
                          f"RMS {slot_rms} from the f32 decode's, over {LM_BF16_RMS_RATIO} x "
                          f"the unsharded bf16's {slot_base}")
    changed = [r_["unwritten_changed"] for r_ in recs]
    line["unwritten_slots_changed"] = "/".join(map(str, changed))
    line["short_step_ms"] = "/".join(f"{r_['short_step_ms']:.2f}" for r_ in recs)
    line["placements"] = f"'{recs[0]['placements']}'"
    if any(changed):
        failed.append(f"model_shard/decode: slots no step wrote changed {changed}")


def model_shard_phase(launches: dict, times: dict, dev, card: str) -> None:
    """The model_shard phase (see the module docstring)."""
    import torch.multiprocessing as tmp

    from repro_torch.launch import mesh as mesh_mod

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"chip_smoke_shard_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.empty_cache()  # the card is the spawned processes'
    p0 = time.perf_counter()
    # the dry runs and the unsharded runs, each in a process of its own
    pool = tmp.get_context("spawn").Pool(3, maxtasksperchild=1)
    try:
        os.makedirs(os.path.join(root, "dryrun"))
        dry = {w_: pool.apply_async(model_shard_dryrun, (w_, os.path.join(root, "dryrun")))
               for w_ in ("mesh", "production")}
        refs = pool.apply_async(shard_refs, (root,)).get(timeout=SHARD_TIMEOUT_S)
        ref_s = time.perf_counter() - p0
        free, total = torch.cuda.mem_get_info()
        say("model_shard_refs", card=f"'{card}'", refs_s=f"{ref_s:.1f}",
            parent_allocated_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}",
            parent_reserved_gb=f"{torch.cuda.memory_reserved() / 1e9:.3f}",
            card_free_gb=f"{free / 1e9:.2f}", card_total_bytes=total)
        dry_mesh = dry["mesh"].get(timeout=SHARD_TIMEOUT_S)
        t0 = time.perf_counter()
        grad_max = {k_: v_["grad_max"] for k_, v_ in refs.items() if "grad_max" in v_}
        ranks = mesh_mod.run_ranks(model_shard_rank, int(np.prod(SHARD_MESH)),
                                   args=(root, grad_max),
                                   device=f"cuda:{torch.cuda.current_device()}",
                                   timeout=SHARD_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        prod = dry["production"].get(timeout=SHARD_TIMEOUT_S)
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(root, ignore_errors=True)

    failed = []
    for i_, name in enumerate(SHARD_CELLS):
        dr = dry_mesh[i_]
        recs = [r_["cells"][name] for r_ in sorted(ranks, key=lambda x: x["rank"])]
        line = {"cell": name, "card": f"'{card}'",
                "transport": "'4 ranks on one H100 over gloo, not a multi-card figure'"}
        for r_, rec in enumerate(recs):
            for k_, v_ in rec["launches"].items():
                launches[k_] += v_
            what = f"model_shard/{name} rank {r_}"
            if rec["argument_bytes"] != dr["memory"]["argument_bytes"]:
                failed.append(f"{what}: argument bytes {rec['argument_bytes']} vs the dry "
                              f"run's {dr['memory']['argument_bytes']}")
            if rec["collectives"]["total_bytes"] != dr["collectives"]["total_bytes"]:
                failed.append(f"{what}: collectives {rec['collectives']} vs the dry run's "
                              f"{dr['collectives']}")
            if name not in ("prefill", "decode"):
                # bfloat16 compute (train): the loss within 2^-7; float32: 1e-4
                want, rtol = refs[name]["losses"][1], 2.0**-7 if name == "train" else 1e-4
                if abs(rec["loss"] - want) > rtol * abs(want):
                    failed.append(f"{what}: loss {rec['loss']} vs {want} (rtol {rtol})")
            tag = f"r{r_}"
            line[f"{tag}_step_ms"] = f"{rec['step_ms']:.2f}"
            line[f"{tag}_peak_gb"] = f"{rec['peak_gb']:.3f}"
            line[f"{tag}_coll_bytes"] = "/".join(
                f"{k_}={v_}" for k_, v_ in sorted(rec["collectives"]["total_bytes"].items()))
            line[f"{tag}_coll_count"] = "/".join(
                f"{k_}={v_}" for k_, v_ in sorted(rec["collectives"]["count"].items()))
            line[f"{tag}_launches"] = "/".join(f"{k_}={v_}" for k_, v_ in rec["launches"].items()) or "none"
        line["dry_peak_gb"] = f"{dr['memory']['peak_bytes'] / 1e9:.3f}"
        line["argument_bytes"] = dr["memory"]["argument_bytes"]
        line["flops_per_rank"] = f"{dr['cost']['flops']:.4e}"

        def leaf_sums(key):
            # each leaf's sums over the ranks' shards (a leaf replicated over
            # an axis counts each element once a replica, on both sides)
            out = {}
            for rec in recs:
                for k_, v_ in rec[key].items():
                    acc = out.setdefault(k_, dict.fromkeys(v_, 0.0))
                    for f_, x_ in v_.items():
                        acc[f_] = max(acc[f_], x_) if f_ == "max_abs" else acc[f_] + x_
            return out

        if name == "decode":
            hold_decode(recs, refs[name], line, failed)
        elif name == "prefill":
            # ROADMAP.md §3's bf16-model bound on the sharded model: its
            # logits' RMS distance from the f32 model (unsharded, plain
            # attention) at most LM_BF16_RMS_RATIO x that of the unsharded
            # bf16 model through the plain attention, and (the kernel alone)
            # of the same sharded model through the plain attention.  The
            # data-rank-0 ranks' shards: the batch of 1 is replicated over data
            def rms_of(key):
                shards = [r_["cells"][name][key] for r_ in ranks if r_["coord"][0] == 0]
                return float(np.sqrt(sum(s_["sq"] for s_ in shards)
                                     / sum(s_["n"] for s_ in shards)))

            rms, plain, unsharded = rms_of("logits"), rms_of("logits_plain"), refs[name]["plain_rms"]
            line.update(rms_vs_f32=f"{rms:.4e}", unsharded_plain_rms_vs_f32=f"{unsharded:.4e}",
                        ratio=f"{rms / unsharded:.4f}", sharded_plain_rms_vs_f32=f"{plain:.4e}",
                        ratio_vs_sharded_plain=f"{rms / plain:.4f}")
            for base, what in ((unsharded, "the unsharded"), (plain, "the same sharded")):
                if not rms <= LM_BF16_RMS_RATIO * base:
                    failed.append(f"model_shard/prefill: logits' RMS distance {rms} from the f32 "
                                  f"model exceeds {LM_BF16_RMS_RATIO} x {base}, {what} model's "
                                  f"through the plain attention")
        else:
            line["loss"] = f"{recs[0]['loss']:.6f}"
            line["ref_loss"] = f"{refs[name]['losses'][1]:.6f}"
            params = leaf_sums("params")
            line["param_max_abs_diff"] = f"{max(v_['max_abs'] for v_ in params.values()):.3e}"
            # each leaf's RMS distance from the unsharded run over its RMS
            # change in the two steps
            step = {k_: np.sqrt(v_["sq"] / max(v_["sq_step"], 1e-300)) for k_, v_ in params.items()}
            line["param_rms_diff_over_change"] = f"{max(step.values()):.4e}"
            if name == "train":
                far = {k_: v_ for k_, v_ in step.items() if v_ > SHARD_BF16_STEP_RATIO}
                if far:
                    failed.append(f"model_shard/train: leaves beyond {SHARD_BF16_STEP_RATIO} of "
                                  f"their change: {far}")
        if name == "sampled":
            sub = leaf_sums("subgraph")
            line["subgraph_elements_checked"] = int(sum(v_["n"] for v_ in sub.values()))
            line["subgraph_placements"] = f"'{recs[0]['subgraph_placements']}'"
            off = {k_: v_ for k_, v_ in sub.items() if v_["bad"] or v_["max_abs"]}
            if off:
                failed.append(f"model_shard/sampled: the subgraph differs from the unsharded "
                              f"one: {off}")
        if name in SHARD_F32_LIMITS:
            lim = SHARD_F32_LIMITS[name]
            grads = leaf_sums("grads")
            g_rms = {k_: np.sqrt(v_["sq"] / v_["sq_ref"]) for k_, v_ in grads.items()
                     if v_["sq_ref"]}
            g_share = sum(v_["bad"] for v_ in grads.values()) / sum(v_["n"] for v_ in grads.values())
            p_share = sum(v_["bad"] for v_ in params.values()) / sum(v_["n"] for v_ in params.values())
            line.update({
                "grad_max_abs_diff": f"{max(v_['max_abs'] for v_ in grads.values()):.3e}",
                "grad_rel_rms_diff": f"{max(g_rms.values()):.4e}",
                "grads_beyond_1e-4_1e-6max": int(sum(v_["bad"] for v_ in grads.values())),
                "grads_checked": int(sum(v_["n"] for v_ in grads.values())),
                "grad_share_beyond": f"{g_share:.4e}",
                "params_beyond_1e-5_1e-6": int(sum(v_["bad"] for v_ in params.values())),
                "params_checked": int(sum(v_["n"] for v_ in params.values())),
                "param_share_beyond": f"{p_share:.4e}",
                "limits": "/".join(f"{k_}={v_:g}" for k_, v_ in lim.items())})
            far = {k_: v_ for k_, v_ in g_rms.items() if v_ > lim["grad_rms"]}
            if far:
                failed.append(f"model_shard/{name}: grads' RMS distance beyond "
                              f"{lim['grad_rms']} of their RMS: {far}")
            if g_share > lim["grad_share"]:
                failed.append(f"model_shard/{name}: {g_share:.4e} of the grad elements beyond "
                              f"rtol 1e-4, atol 1e-6 max|grad| (limit {lim['grad_share']})")
            if p_share > lim["param_share"]:
                failed.append(f"model_shard/{name}: {p_share:.4e} of the parameters beyond "
                              f"rtol 1e-5, atol 1e-6 (limit {lim['param_share']})")
            far = {k_: v_ for k_, v_ in step.items() if v_ > lim["param_step"]}
            if far:
                failed.append(f"model_shard/{name}: parameters' RMS distance beyond "
                              f"{lim['param_step']} of their change: {far}")
        times[f"model_shard_{name}_step_ms"] = max(rec["step_ms"] for rec in recs)
        say("model_shard", **line)
    for r_ in prod:
        if "compute_s" in r_:
            say("model_shard_roofline", card=f"'{card}'", mesh="16x16",
                modelled="'H100 SXM data-sheet constants'", arch=r_["arch"], shape=r_["shape"],
                compute_s=f"{r_['compute_s']:.4e}", memory_s=f"{r_['memory_s']:.4e}",
                collective_s=f"{r_['collective_s']:.4e}", dominant=r_["dominant"],
                model_flops=f"{r_['model_flops']:.4e}", useful_ratio=f"{r_['useful_ratio']:.4f}",
                roofline_fraction=f"{r_['roofline_fraction']:.4f}")
        else:
            say("model_shard_dryrun", mesh="16x16", **{k_: v_ for k_, v_ in r_.items()})
    say("model_shard_phase", card=f"'{card}'", refs_s=f"{ref_s:.1f}", ranks_s=f"{ranks_s:.1f}",
        phase_s=f"{time.perf_counter() - p0:.1f}")
    if failed:
        raise AssertionError("model_shard: " + "; ".join(failed))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    start = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.configs import base as cfg_base
    from repro_torch.configs import h2o_danube_1_8b, two_tower_retrieval
    from repro_torch.core import DiGraph, csr, edgebatch, traversal, tree, updates, util
    from repro_torch.io import _cparse, mtx, synthetic
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.kernels.bsr_spmm import kernel as bsr_kernel
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.csr_build import kernel as cb_kernel
    from repro_torch.kernels.edge_segment_sum import kernel as seg_kernel
    from repro_torch.kernels.edge_segment_sum import ops as seg_ops
    from repro_torch.kernels.embedding_bag import kernel as bag_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.slot_update import kernel as su_kernel
    from repro_torch.kernels.slot_update import ops as su_ops
    from repro_torch.kernels.slot_walk import kernel as sw_kernel
    from repro_torch.kernels.slot_walk import ops as sw_ops
    from repro_torch.models.recsys import two_tower
    from repro_torch.models.transformer import attention as tattn
    from repro_torch.models.transformer import model as tm

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. env -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), build_s=f"{time.perf_counter() - t0:.2f}")

    # main path: its calls run inside ``counted``; the checks between them
    # (host engine, plain twin, warm-up, normalised walks) launch outside it
    launches = dict.fromkeys(KERNELS, 0)
    times = {}
    phase_s = {}

    # 1a. model_shard (model sharding over a DeviceMesh, 4 ranks on the one
    # card, and the dry run) first: all its work is in processes of its own,
    # which need the card empty of this one's cached memory ---------------
    p0 = time.perf_counter()
    model_shard_phase(launches, times, dev, smi)
    phase_s["model_shard_s"] = time.perf_counter() - p0

    # 1b. gnn_train (the GNN family trained at full width) second, on the
    # emptied card: GraphCast's float32 activations take ~56 GB ------------
    p0 = time.perf_counter()
    gnn_train_phase(launches, times, dev, smi)
    phase_s["gnn_train_s"] = time.perf_counter() - p0

    # 1c. lm_train (LM and two-tower training, the large LMs' cost1
    # prefills) second, on the emptied card -------------------------------
    p0 = time.perf_counter()
    lm_train_phase(launches, times, dev, smi)
    phase_s["lm_train_s"] = time.perf_counter() - p0

    # 2. graph -------------------------------------------------------------
    t0 = sync_now()
    src, dst, wgt, n = synthetic.make_coo(
        "social", scale=SCALE, edge_factor=EDGE_FACTOR, seed=SEED
    )
    gen_s = time.perf_counter() - t0
    t0 = sync_now()
    c = csr.from_coo(src, dst, wgt, n=n, device=dev)  # make_graph's dedup CSR
    dedup_s = time.perf_counter() - t0
    say("graph", kind="social", scale=SCALE, n=n, m_raw=src.shape[0], m=c.m,
        max_degree=int(c.degrees.max()), host_gen_s=f"{gen_s:.1f}",
        host_dedup_s=f"{dedup_s:.1f}")

    # 3. load (paper task 1) --------------------------------------------
    # warm-up: the process's first device build, timed as the cold call
    t0 = sync_now()
    csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="cuda", device=dev)
    first_ms = sync_s(t0) * 1e3
    t0 = sync_now()
    with counted(KERNELS, launches), load_split(csr) as split_coo:
        raw = csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="cuda", device=dev)
    times["load_coo_ms"] = sync_s(t0) * 1e3
    expect_launches("degree_offsets", 1, "load")
    expect_launches("count_degrees", 0, "load")
    host = csr.from_coo(src, dst, wgt, n=n, dedup=False, engine="host", device=dev)
    for f in ("offsets", "dst", "wgt"):
        if not torch.equal(getattr(raw, f), getattr(host, f)):
            raise AssertionError(f"load: cuda engine {f} differs from the host engine")
    del host
    t0 = sync_now()
    with counted(KERNELS, launches):
        g = DiGraph.from_csr(c, device=dev)
    times["load_arena_ms"] = sync_s(t0) * 1e3
    say("load", m_raw=raw.m, cap_e=g.cap_e, bump=g.layout.bump,
        coo_to_csr_ms=f"{times['load_coo_ms']:.1f}", first_call_ms=f"{first_ms:.1f}",
        **{k: f"{v_:.4f}" for k, v_ in split_coo.items() if k != "from_coo_host_ms"},
        csr_to_arena_ms=f"{times['load_arena_ms']:.1f}", host_engine="bit-identical")

    # 3b. load_file (paper task 1 from a file) ----------------------------
    p0 = time.perf_counter()
    if not _cparse.available():
        raise AssertionError("load_file: the compiled row parser did not build")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"chip_smoke_{os.getpid()}.mtx")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        t0 = time.perf_counter()
        mtx.write_mtx(path, raw)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        file_split = {}
        for name in ("load_mtx", "load_digraph"):
            t0 = sync_now()
            getattr(mtx, name)(path, device=dev)  # warm-up: pools, the parser's scratch
            file_split[f"{name}_first_call_ms"] = sync_s(t0) * 1e3
            calls = _cparse.parse_fixed_rows.calls
            t0 = sync_now()
            with counted(KERNELS, launches), load_split(csr) as parts, \
                    timed_calls(mtx, "load_mtx") as lm:
                out = getattr(mtx, name)(path, device=dev)
            times[f"{name}_ms"] = sync_s(t0) * 1e3
            expect_launches("degree_offsets", 1, f"load_file/{name}")
            parts["parse_host_ms"] = lm[0][2] * 1e3 - parts.pop("from_coo_host_ms")
            if name == "load_digraph":
                parts["arena_host_ms"] = times[f"{name}_ms"] - lm[0][2] * 1e3
            file_split.update({f"{name}_{k}": v_ for k, v_ in parts.items()})
            file_split[f"{name}_parser_calls"] = _cparse.parse_fixed_rows.calls - calls
            if file_split[f"{name}_parser_calls"] == 0:
                raise AssertionError(f"load_file: {name} did not parse in the compiled parser")
            if name == "load_mtx":
                for f in ("offsets", "dst", "wgt"):
                    if not torch.equal(getattr(out, f).view(torch.int32),
                                       getattr(raw, f).view(torch.int32)):
                        raise AssertionError(f"load_file: load_mtx {f} differs from the raw CSR")
                direct = DiGraph.from_csr(out, device=dev)
            else:
                for f in ("dst", "wgt", "slot_rows"):
                    if not torch.equal(getattr(out, f).view(torch.int32),
                                       getattr(direct, f).view(torch.int32)):
                        raise AssertionError(f"load_file: load_digraph {f} differs")
                for f in ("starts", "capacities", "degrees"):
                    if not np.array_equal(getattr(out, f), getattr(direct, f)):
                        raise AssertionError(f"load_file: load_digraph {f} differs")
            del out
        del direct
    finally:
        if os.path.exists(path):
            os.remove(path)
    phase_s["load_file_s"] = time.perf_counter() - p0
    say("load_file", bytes=size, lines=raw.m, write_s=f"{write_s:.1f}",
        load_mtx_ms=f"{times['load_mtx_ms']:.1f}",
        load_digraph_ms=f"{times['load_digraph_ms']:.1f}",
        **{k: (v_ if isinstance(v_, int) else f"{v_:.4f}") for k, v_ in file_split.items()},
        csr="bit-identical to the raw CSR", arena="equal to DiGraph.from_csr of it")
    del raw

    # 4. clone (paper task 2) -------------------------------------------
    t0 = sync_now()
    with counted(KERNELS, launches):
        twin = g.clone()
    times["clone_ms"] = sync_s(t0) * 1e3
    for f in ("dst", "wgt", "slot_rows"):
        if not torch.equal(getattr(twin, f), getattr(g, f)):
            raise AssertionError(f"clone: {f} differs")
    say("clone", ms=f"{times['clone_ms']:.2f}", buffers="equal")

    # 5. update (paper task 3) ------------------------------------------
    snap = g.snapshot()
    sums = {f: checksum(getattr(snap, f)) for f in ("dst", "wgt", "slot_rows")}
    rng = np.random.default_rng(SEED + 1)
    m0 = g.m
    n_small = round(1e-3 * m0)
    n_half = round(0.5e-2 * m0)
    batches = [
        ("delete", lambda: updates.plan_update(
            deletes=edgebatch.random_deletions(rng, g.to_csr(), n_small))),
        ("insert", lambda: updates.plan_update(
            inserts=edgebatch.random_insertions(rng, n, n_small, weighted_range=(0.5, 1.5)))),
        ("mixed", lambda: updates.plan_update(
            inserts=edgebatch.random_insertions(rng, n, n_half, weighted_range=(0.5, 1.5)),
            deletes=edgebatch.random_deletions(rng, g.to_csr(), n_half))),
    ]
    merge_case = None
    plans = []

    def keep_merge(args, kwargs):
        """The arena and [lo, hi) as the apply found them, and its largest
        width group (by rows): the other groups touch other blocks."""
        dst_, wgt_, rows_, groups_, lo_, hi_, _backend = args
        big = max(groups_, key=lambda g_: g_[1])
        clone = lambda t_: None if t_ is None else t_.clone()  # noqa: E731
        return (dst_.clone(), wgt_.clone(), rows_.clone(), big, clone(lo_), clone(hi_)), {}

    for name, make in batches:
        plan = make()
        plans.append((name, plan))
        # warm-up: the same plan on a copy, timed as the first call of this
        # batch (the batch a stream of updates starts with pays its costs)
        warm = g.clone()
        with timed_calls(su_ops, "fused_apply") as fa0:
            t0 = sync_now()
            warm.apply(plan)
            first_ms = sync_s(t0) * 1e3
        first_fused_ms = sum(a_.elapsed_time(b_) for a_, b_, _ in fa0)
        del warm
        if name == "mixed":  # its largest merge launch (by rows), as dispatched
            with largest_call(su_ops, "_merge_in_place", lambda args: 0, keep_merge) as seen:
                g.clone().apply(plan)
            merge_case = seen["args"]
        t0 = sync_now()
        with counted(KERNELS, launches), timed_calls(su_ops, "fused_apply") as fa:
            _, dm = g.apply(plan)
        times[f"{name}_ms"] = sync_s(t0) * 1e3
        fused_ms = sum(a_.elapsed_time(b_) for a_, b_, _ in fa)
        rest_ms = times[f"{name}_ms"] - sum(h_ for _, _, h_ in fa) * 1e3
        merges = KERNELS["merge_rows_fused"].launches
        t0 = sync_now()
        twin.apply(plan, backend="torch")
        plain_ms = sync_s(t0) * 1e3
        assert_same_state(g, twin, f"update/{name}")
        if g.m != int(g.degrees.sum()):
            raise AssertionError(f"update/{name}: m != degrees.sum()")
        say("update", batch=name, ops=plan.n_ops, rows=plan.n_rows, dm=dm, m=g.m,
            ms=f"{times[f'{name}_ms']:.1f}", fused_apply_event_ms=f"{fused_ms:.4f}",
            rest_of_apply_ms=f"{rest_ms:.4f}", first_call_ms=f"{first_ms:.1f}",
            first_call_fused_apply_event_ms=f"{first_fused_ms:.4f}", merge_launches=merges,
            plain_twin_ms=f"{plain_ms:.1f}", twin="state_tree identical")
    for f, s in sums.items():
        if checksum(getattr(snap, f)) != s:
            raise AssertionError(f"update: snapshot buffer {f} changed")
    say("update", snapshot="unchanged")
    del twin, snap

    # 6. walk (paper task 4) --------------------------------------------
    g.reverse_walk(1)  # warm-up: allocator and interval cache
    t0 = sync_now()
    with counted(KERNELS, launches):
        v = g.reverse_walk(WALK_STEPS)
    times["walk_ms"] = sync_s(t0) * 1e3
    nv = g.n_max_vertex() + 1
    if tuple(v.shape) != (nv,):
        raise AssertionError(f"walk: shape {tuple(v.shape)} != ({nv},)")
    img = g.to_walk_image()
    vk = img.walk(WALK_STEPS, normalize=True, backend="cuda")
    vp = img.walk(WALK_STEPS, normalize=True, backend="torch")
    if not (bool(torch.isfinite(vk).all()) and bool(torch.isfinite(vp).all())):
        raise AssertionError("walk: non-finite normalised visits")
    diff = (vk - vp).abs()
    nz = vp != 0
    rel = float((diff[nz] / vp[nz].abs()).max())
    torch.testing.assert_close(vk, vp, rtol=WALK_RTOL, atol=WALK_ATOL)
    say("walk", steps=WALK_STEPS, nv=nv, edges_hi=img.edges_hi(),
        ms=f"{times['walk_ms']:.1f}", normalized_max_abs_diff=f"{float(diff.max()):.3e}",
        normalized_max_rel_diff_nonzero=f"{rel:.3e}")

    # 7. walk_slotted (paper task 4, interval-less rank tiles) -------------
    p0 = time.perf_counter()
    ehi = img.edges_hi()
    traversal.reverse_walk_slotted(g.dst, g.slot_rows, 1, nv, edges_hi=ehi)  # warm-up
    t0 = sync_now()
    with counted(KERNELS, launches):
        vs = traversal.reverse_walk_slotted(g.dst, g.slot_rows, WALK_STEPS, nv, edges_hi=ehi)
    times["walk_slotted_ms"] = sync_s(t0) * 1e3
    expect_launches("slot_walk_partials", WALK_STEPS, "walk_slotted")
    if tuple(vs.shape) != (nv,):
        raise AssertionError(f"walk_slotted: shape {tuple(vs.shape)} != ({nv},)")
    del vs
    vsk = traversal.reverse_walk_slotted(g.dst, g.slot_rows, WALK_STEPS, nv, edges_hi=ehi,
                                         normalize=True, backend="cuda")
    vsp = traversal.reverse_walk_slotted(g.dst, g.slot_rows, WALK_STEPS, nv, edges_hi=ehi,
                                         normalize=True, backend="torch")
    if not bool(torch.isfinite(vsk).all()):
        raise AssertionError("walk_slotted: non-finite normalised visits")
    torch.testing.assert_close(vsk, vsp, rtol=WALK_RTOL, atol=WALK_ATOL)
    torch.testing.assert_close(vsk, vk, rtol=WALK_RTOL, atol=WALK_ATOL)
    v0 = np.ones((4, nv), np.float32)
    v0[1:] = np.random.default_rng(SEED).random((3, nv), dtype=np.float32)
    v0 = torch.from_numpy(v0).to(dev)
    batched = dict.fromkeys(KERNELS, 0)
    t0 = sync_now()
    with counted(KERNELS, batched):
        vbk = traversal.reverse_walk_slotted(g.dst, g.slot_rows, WALK_STEPS, nv, edges_hi=ehi,
                                             normalize=True, visits0=v0)
    times["walk_slotted_b4_ms"] = sync_s(t0) * 1e3
    expect_launches("slot_walk_partials", WALK_STEPS, "walk_slotted/B=4")
    vbp = traversal.reverse_walk_slotted(g.dst, g.slot_rows, WALK_STEPS, nv, edges_hi=ehi,
                                         normalize=True, visits0=v0, backend="torch")
    if tuple(vbk.shape) != (4, nv):
        raise AssertionError(f"walk_slotted/B=4: shape {tuple(vbk.shape)} != (4, {nv})")
    torch.testing.assert_close(vbk, vbp, rtol=WALK_RTOL, atol=WALK_ATOL)
    torch.testing.assert_close(vbk[0], vsk, rtol=WALK_RTOL, atol=WALK_ATOL)
    del vbk, vbp, v0, vsp
    # one step's split, at the walk's shapes (normalised visits as input)
    rows_f, gidx_f = sw_ops._prep(g.dst, g.slot_rows, nv, ehi)
    sw_rows = rows_f.to(torch.int32).reshape(-1, sw_kernel.EB)
    del rows_f
    vis = torch.cat([vsk, vsk.new_zeros(1)])[None]
    gather = lambda: vis.index_select(1, gidx_f).reshape(-1, sw_kernel.EB)  # noqa: E731
    sw_vals = gather()
    part, rank = sw_kernel.slot_walk_partials(sw_rows, sw_vals, nv)
    split = dict(
        step_ms=time_ms(lambda: sw_ops._fold_live(
            *sw_kernel.slot_walk_partials(sw_rows, gather(), nv), 1, nv)),
        gather_ms=time_ms(gather),
        partials_ms=time_ms(lambda: sw_kernel.slot_walk_partials(sw_rows, sw_vals, nv)),
        fold_ms=time_ms(lambda: sw_ops._fold_live(part, rank, 1, nv)),
    )
    live = float((rank < nv).float().mean())
    del part, rank, gidx_f, vis
    say("walk_slotted", steps=WALK_STEPS, nv=nv, edges_hi=ehi, tiles=sw_rows.shape[0],
        ms=f"{times['walk_slotted_ms']:.1f}", b4_ms=f"{times['walk_slotted_b4_ms']:.1f}",
        **{k: f"{v_:.4f}" for k, v_ in split.items()},
        fold_share=f"{split['fold_ms'] / split['step_ms']:.3f}",
        live_rank_share=f"{live:.4f}",
        vs_plain="rtol 5e-4", vs_image_walk="rtol 5e-4", b4_vs_plain="rtol 5e-4")
    phase_s["walk_slotted_s"] = time.perf_counter() - p0

    # 7b. stream (paper tasks 1-4 on the other four representations) -----
    p0 = time.perf_counter()
    stream_phase(c, g, plans, vk, launches, times, dev)
    phase_s["stream_s"] = time.perf_counter() - p0

    # 7c. durable (WAL, checkpoints, crash recovery on the card) ----------
    p0 = time.perf_counter()
    durable_phase(c, launches, times, dev, smi)
    phase_s["durable_s"] = time.perf_counter() - p0

    # 7d. serve (WalkServer over sealed generations, on the card) ---------
    p0 = time.perf_counter()
    serve_phase(g, launches, times, dev, smi)
    phase_s["serve_s"] = time.perf_counter() - p0

    # 7e. sharded (ShardedGraph in local mode: failover, durability) ------
    p0 = time.perf_counter()
    sharded_phase(c, g, plans, launches, times, dev, smi)
    phase_s["sharded_s"] = time.perf_counter() - p0

    # 7f. mesh (the sharded graph on 4 ranks sharing the card, over gloo) --
    p0 = time.perf_counter()
    mesh_phase(c, g, plans, launches, times, dev, smi)
    phase_s["mesh_s"] = time.perf_counter() - p0

    # 8. walk_bsr (paper task 4 as iterated block-sparse SpMM) ------------
    p0 = t0 = sync_now()
    rsrc, rdst, _, rn = synthetic.make_coo("road", scale=ROAD_SCALE, seed=SEED,
                                           weighted=False)
    road_gen_s = time.perf_counter() - t0
    t0 = sync_now()
    road = csr.from_coo(rsrc, rdst, n=rn, device=dev)  # dedup: one entry per pair
    road_dedup_s = time.perf_counter() - t0
    del rsrc, rdst
    t0 = sync_now()
    bsr = bsr_ops.csr_to_bsr(road)
    times["bsr_build_ms"] = sync_s(t0) * 1e3
    nnzb = bsr.block_cols.shape[0]
    n_rb = bsr.row_ptr.shape[0] - 1
    say("walk_bsr", graph="road", scale=ROAD_SCALE, n=rn, m=road.m, nnzb=nnzb,
        tiles_gb=f"{bsr.blocks.numel() * 4 / 1e9:.2f}",
        blocks_per_row_block=f"{nnzb / n_rb:.4f}", max_blocks_per_row=bsr.max_blocks_per_row,
        host_gen_s=f"{road_gen_s:.1f}", host_dedup_s=f"{road_dedup_s:.1f}",
        build_ms=f"{times['bsr_build_ms']:.1f}")
    bsr_ops.reverse_walk_bsr(bsr, 1, rn)  # warm-up
    t0 = sync_now()
    with counted(KERNELS, launches):
        vb = bsr_ops.reverse_walk_bsr(bsr, WALK_STEPS, rn)
    times["walk_bsr_ms"] = sync_s(t0) * 1e3
    expect_launches("bsr_spmm", WALK_STEPS, "walk_bsr")
    if tuple(vb.shape) != (rn,) or not bool((torch.isfinite(vb) & (vb > 0)).all()):
        raise AssertionError("walk_bsr: visits not finite and positive of shape (n,)")
    vbp = bsr_ops.reverse_walk_bsr(bsr, WALK_STEPS, rn, backend="torch")
    torch.testing.assert_close(vb, vbp, rtol=EXACT_WALK_RTOL, atol=0.0)
    rel_plain = float(((vb - vbp).abs() / vbp).max())
    del vbp
    rg = DiGraph.from_csr(road, device=dev)
    rnv = rg.n_max_vertex() + 1
    vr = traversal.reverse_walk_slotted(rg.dst, rg.slot_rows, WALK_STEPS, rnv,
                                        edges_hi=rg.to_walk_image().edges_hi())
    torch.testing.assert_close(vb[:rnv], vr, rtol=EXACT_WALK_RTOL, atol=0.0)
    rel_slotted = float(((vb[:rnv] - vr).abs() / vr).max())
    # the image walk's prefix differences keep ~ulp of a tile's running sum:
    # on a road graph the visits span ~10 orders of magnitude, so small rows
    # lose their digits (repro's DiGraph walk does the same); held after
    # normalising, at the image walk's own tolerances
    vi = rg.reverse_walk(WALK_STEPS)
    rel_image = float(((vb[:rnv] - vi).abs() / vb[:rnv]).max())
    torch.testing.assert_close(vi / vi.max(), vb[:rnv] / vb.max(), rtol=WALK_RTOL,
                               atol=WALK_ATOL)
    # the stream walk's gather: one row of visits at the road image's index
    rimg = rg.to_walk_image()
    road_gather_row = slot_gather_row(
        sw_kernel, torch.rand((1, rimg.nv), generator=torch.Generator(dev).manual_seed(SEED),
                              device=dev),
        sw_ops._prep_gidx(rimg.dst, rimg.nv, rimg.edges_hi()), "the road walk")
    del vr, vi, rg, rimg
    say("walk_bsr", steps=WALK_STEPS, ms=f"{times['walk_bsr_ms']:.1f}",
        max_rel_diff_plain=f"{rel_plain:.3e}", max_rel_diff_slotted=f"{rel_slotted:.3e}",
        max_rel_diff_image_walk=f"{rel_image:.3e}", vs_plain="rtol 1e-4",
        vs_slotted="rtol 1e-4", vs_image_walk="normalised, rtol 5e-4")

    # bsr_spmm against its plain version at the walk's shapes, while the
    # tiles are on the card (freed before the other kernel rows)
    x = torch.zeros((bsr.n_cols, 8), dtype=torch.float32, device=dev)
    x[:rn, 0] = vb / vb.max()
    del vb
    bargs = (bsr.row_ptr, bsr.block_cols, bsr.blocks, x)
    got, ref = bsr_kernel.bsr_spmm(*bargs, d_tile=8), bsr_kernel.bsr_spmm_torch(*bargs)
    torch.testing.assert_close(got, ref, rtol=SPMM_RTOL, atol=0.0)
    bsr_row = dict(
        name="bsr_spmm", source="src/repro_torch/csrc/bsr_spmm.cu",
        replaces="src/repro/kernels/bsr_spmm/kernel.py:53",
        shape=f"nnzb={nnzb} R={n_rb} D=8 d_tile=8", max_abs_err=float((got - ref).abs().max()),
        tolerance="rtol 1e-5",
        ms=time_ms(lambda: bsr_kernel.bsr_spmm(*bargs, d_tile=8)),
        plain_ms=time_ms(lambda: bsr_kernel.bsr_spmm_torch(*bargs), reps=5),
        library_ms=None,
        bytes=nnzb * 128 * 128 * 4 + (n_rb + 1) * 4 + nnzb * 4 + x.numel() * 4 + got.numel() * 4,
        ops=2 * nnzb * 128 * 128 * 8,
    )
    try:  # the yardstick only: PyTorch's own BSR product, if it runs on CUDA
        a_sp = torch.sparse_bsr_tensor(bsr.row_ptr, bsr.block_cols, bsr.blocks[:nnzb],
                                       size=(bsr.n_rows, bsr.n_cols), check_invariants=False)
        lib = a_sp @ x
        torch.testing.assert_close(lib, ref, rtol=SPMM_RTOL, atol=0.0)
        bsr_row["library_ms"] = time_ms(lambda: a_sp @ x, reps=5)
        lib_note = "torch.sparse_bsr_tensor @ x"
        del lib, a_sp
    except (RuntimeError, NotImplementedError, AssertionError) as e:
        lib_note = f"none: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    say("walk_bsr", library=lib_note)
    del got, ref, x, bargs, bsr, road
    torch.cuda.empty_cache()
    phase_s["walk_bsr_s"] = time.perf_counter() - p0

    # 9. segment_sum (GNN neighbour aggregation over the social CSR) -------
    p0 = time.perf_counter()
    seg_rows = util.expand_rows(c.offsets, c.m)  # each edge's CSR row, ascending
    dst_l = c.dst.long()
    deg = c.degrees.to(torch.float64)[:, None]
    gamma = deg * U / (1 - deg * U)  # a sum of deg terms: within gamma*sum|terms|
    sgen = torch.Generator(device=dev).manual_seed(SEED)
    seg_row = None
    seg_offsets = util.host(c.offsets)
    seg_cuts = np.linspace(0, n, 5).astype(np.int64)
    torch.cuda.reset_peak_memory_stats()
    phase_peak_gb = 0.0
    # the plain formulation's pieces, which the CUDA path must not call
    plain_parts = ("pad", "edge_segment_partials_torch", "fold_live")
    for d in SEG_WIDTHS:
        h = torch.randn((n, d), generator=sgen, device=dev)
        vals = h.index_select(0, dst_l)  # [E, d]: the symmetrised graph's messages
        op = lambda: seg_ops.edge_segment_sum(seg_rows, vals, num_segments=n)  # noqa: E731
        op()  # warm-up
        phase_peak_gb = max(phase_peak_gb, torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        before_gb = torch.cuda.memory_allocated() / 1e9
        with count_calls(seg_kernel, plain_parts) as calls:
            t0 = sync_now()
            with counted(KERNELS, launches):
                torch.cuda.set_sync_debug_mode("error")  # no nonzero, no .item()
                try:
                    out = op()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            times[f"seg_sum_d{d}_ms"] = sync_s(t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        phase_peak_gb = max(phase_peak_gb, peak_gb)
        torch.cuda.reset_peak_memory_stats()
        expect_launches("edge_segment_runs", 1, f"segment_sum/D={d}")
        if any(calls.values()):
            raise AssertionError(f"segment_sum/D={d}: the CUDA path called {calls}")
        if tuple(out.shape) != (n, d) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"segment_sum/D={d}: not finite of shape ({n}, {d})")
        if not all(torch.equal(op(), out) for _ in range(2)):
            raise AssertionError(f"segment_sum/D={d}: two calls differ")
        op_ms = time_ms(op, reps=5)
        lib_fn = lambda: torch.zeros((n, d), device=dev).index_add_(0, seg_rows, vals)  # noqa: E731
        lib = lib_fn()
        library_ms = time_ms(lib_fn, reps=5)
        # the plain op over four row ranges (each row whole in one), so the
        # phase never holds the plain op's padded copy of all the edges
        plain = torch.empty_like(out)
        for r0, r1 in zip(seg_cuts[:-1], seg_cuts[1:]):
            e0, e1 = int(seg_offsets[r0]), int(seg_offsets[r1])
            plain[r0:r1] = seg_ops.edge_segment_sum(seg_rows[e0:e1] - r0, vals[e0:e1],
                                                    num_segments=r1 - r0, backend="torch")
        # float64 sums and each row's sum of |terms|, 8 columns at a time
        ref = torch.empty((n, d), dtype=torch.float64, device=dev)
        absum = torch.empty_like(ref)
        for j in range(0, d, 8):
            hj = h[:, j:j + 8].double().index_select(0, dst_l)
            w = hj.shape[1]
            ref[:, j:j + w] = torch.zeros((n, w), dtype=torch.float64,
                                          device=dev).index_add_(0, seg_rows, hj)
            absum[:, j:j + w] = torch.zeros((n, w), dtype=torch.float64,
                                            device=dev).index_add_(0, seg_rows, hj.abs_())
            del hj
        # any float32 summation of a row's deg terms is within
        # gamma*sum|terms| of the float64 sum; two of them within twice that
        bound = gamma * absum
        out64, lib64 = out.double(), lib.double()
        for what, diff, tol in (("op vs float64", out64 - ref, bound),
                                ("index_add_ vs float64", lib64 - ref, bound),
                                ("op vs index_add_", out64 - lib64, 2 * bound),
                                ("op vs plain op", out64 - plain.double(), 2 * bound)):
            if not bool((diff.abs() <= tol).all()):
                raise AssertionError(f"segment_sum/D={d}: {what} exceeds gamma(deg)*sum|terms|")
        err64 = float((out64 - ref).abs().max())
        lib_err64 = float((lib64 - ref).abs().max())
        err_lib = float((out - lib).abs().max())
        err_plain = float((out - plain).abs().max())
        outside = float(((out - lib).abs() > 1e-5 + 1e-5 * lib.abs()).float().mean())
        del lib, plain, ref, absum, bound, out, out64, lib64, diff
        torch.cuda.empty_cache()
        kernel_ms = time_ms(lambda: seg_kernel.edge_segment_runs(seg_rows, vals, n))
        phase_peak_gb = max(phase_peak_gb, torch.cuda.max_memory_allocated() / 1e9)
        plain_ms = None
        if d == SEG_ROW_D:  # the whole plain op, timed for the kernels line
            plain_ms = time_ms(lambda: seg_kernel.edge_segment_sum_torch(seg_rows, vals, n),
                               reps=3)
        e_edges = seg_rows.shape[0]
        seg_bytes = 4 * e_edges + 4 * d * e_edges + 4 * d * n
        say("segment_sum", D=d, E=e_edges, tiles=-(-e_edges // seg_kernel.EB),
            ms=f"{times[f'seg_sum_d{d}_ms']:.2f}", op_ms=f"{op_ms:.4f}",
            kernel_ms=f"{kernel_ms:.4f}",
            plain_op_ms="not timed" if plain_ms is None else f"{plain_ms:.4f}",
            index_add_ms=f"{library_ms:.4f}",
            bound_ms=f"{seg_bytes / HBM_BYTES_PER_S * 1e3:.4f}",
            inputs_gb=f"{before_gb:.3f}", op_peak_gb=f"{peak_gb:.3f}",
            max_abs_err_vs_float64=f"{err64:.3e}",
            index_add_max_abs_err_vs_float64=f"{lib_err64:.3e}",
            max_abs_diff_vs_index_add=f"{err_lib:.3e}",
            max_abs_diff_vs_plain=f"{err_plain:.3e}",
            share_outside_1e5_of_index_add=f"{outside:.3e}",
            bit_identical_calls=3, plain_parts_called=0, host_syncs=0,
            tolerance="gamma(deg)*sum|terms| (vs float64), twice that (vs index_add_, plain)")
        if d == SEG_ROW_D:
            seg_row = dict(
                name="edge_segment_runs", source="src/repro_torch/csrc/edge_segment_sum.cu",
                replaces="src/repro/kernels/edge_segment_sum/kernel.py:46",
                shape=f"E={e_edges} n={n} D={d}: [E] i32 rows + [E,{d}] f32 vals, in place",
                max_abs_err=err_plain,
                tolerance="2*gamma(deg)*sum|terms| of the plain op",
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes=seg_bytes, ops=e_edges * d,
            )
        if d == SEG_ROW_D:
            # small-integer messages: every partial sum is exact in float32,
            # so the op must equal index_add_ bit for bit on every row, and
            # one seam dropped or added twice on a hub row would show
            max_deg = int(c.degrees.max())
            if max_deg * 8 >= 2**24:
                raise AssertionError("segment_sum: integer sums would not be exact")
            qgen = torch.Generator(device=dev).manual_seed(SEED + 2)
            vq = torch.randint(-8, 9, (n, d), generator=qgen, device=dev).float().index_select(
                0, dst_l)
            exact = torch.equal(seg_ops.edge_segment_sum(seg_rows, vq, num_segments=n),
                                torch.zeros((n, d), device=dev).index_add_(0, seg_rows, vq))
            if not exact:
                raise AssertionError(f"segment_sum/D={d}: integer messages not summed exactly")
            say("segment_sum", D=d, integer_messages="equal to index_add_",
                max_row_edges=max_deg, max_row_tiles=-(-max_deg // seg_kernel.EB) + 1)
            del vq
        del vals, h, op, lib_fn
        torch.cuda.empty_cache()
    phase_peak_gb = max(phase_peak_gb, torch.cuda.max_memory_allocated() / 1e9)
    say("segment_sum", phase_peak_gb=f"{phase_peak_gb:.3f}",
        plain_check="four row ranges, each row whole in one")
    del seg_rows, dst_l, deg, gamma
    phase_s["segment_sum_s"] = time.perf_counter() - p0

    # 10. two_tower (two-tower retrieval serving at FULL width) -----------
    p0 = time.perf_counter()
    cfg = two_tower_retrieval.FULL
    tgen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = sync_now()
    model = two_tower.init_model(cfg, generator=tgen, device=dev)
    init_s = sync_s(t0)
    plain_model = model.with_backend("torch")
    kb = cfg.bag_size

    def make_bags(nb: int, nf: int, vocab: int) -> torch.Tensor:
        """Ids uniform over [-1, vocab), as the recsys cells of
        ``src/repro/launch/steps.py`` draw them: practically full bags."""
        return torch.randint(-1, vocab, (nb, nf, kb), generator=tgen, device=dev,
                             dtype=torch.int32)

    def make_ragged_bags(nb: int, nf: int, vocab: int) -> torch.Tensor:
        """Bags cut to a ragged -1 tail (lengths uniform in 0..K), so empty
        bags and the mean's count are exercised; checked, never timed."""
        lens = torch.randint(0, kb + 1, (nb, nf, 1), generator=tgen, device=dev)
        return torch.where(torch.arange(kb, device=dev) < lens, make_bags(nb, nf, vocab), -1)

    shapes = cfg_base.RECSYS_SHAPES
    serve = {}
    for name in ("serve_p99", "serve_bulk"):
        b = shapes[name]["batch"]
        batch = {"user_bags": make_bags(b, cfg.n_user_fields, cfg.n_users),
                 "item_bags": make_bags(b, cfg.n_item_fields, cfg.n_items)}
        model.serve_step(batch)  # warm-up
        t0 = sync_now()
        with counted(KERNELS, launches):
            scores = model.serve_step(batch)
        times[f"{name}_ms"] = sync_s(t0) * 1e3
        expect_launches("embedding_bag", 2, f"two_tower/{name}")
        if tuple(scores.shape) != (b,) or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"two_tower/{name}: scores not finite of shape ({b},)")
        torch.testing.assert_close(scores, plain_model.serve_step(batch),
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)
        serve[name] = dict(batch=batch, event_ms=time_ms(lambda: model.serve_step(batch),
                                                         reps=20 if b < 4096 else 5))
    # serve_p99's latency spread: host-synced calls one after another
    p99_batch = serve["serve_p99"]["batch"]
    lat = []
    for _ in range(P99_CALLS):
        t0 = sync_now()
        model.serve_step(p99_batch)
        lat.append(sync_s(t0) * 1e3)
    p99_lat = np.percentile(lat, [50, 99])
    # ragged bags: the model and the bag kernel against the plain bag
    rag = {"user_bags": make_ragged_bags(RAGGED_BATCH, cfg.n_user_fields, cfg.n_users),
           "item_bags": make_ragged_bags(RAGGED_BATCH, cfg.n_item_fields, cfg.n_items)}
    scores = model.serve_step(rag)
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError("two_tower/ragged: scores not finite")
    torch.testing.assert_close(scores, plain_model.serve_step(rag),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    table = model.user.table.detach()
    # mean of <= K rows summed in two roundings (FMA, product then add):
    # within 2*K*U*sum|row| <= 2*K*K*U*max|table| of each other
    bag_atol = 2 * kb * kb * U * float(table.abs().max())
    idx = rag["user_bags"].reshape(-1, kb)
    wts = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    got = bag_kernel.embedding_bag(table, idx, wts, "mean")
    torch.testing.assert_close(got, bag_kernel.embedding_bag_torch(table, idx, wts, "mean"),
                               rtol=0.0, atol=bag_atol)
    empty = (idx < 0).all(dim=1)
    n_empty = int(empty.sum())
    if n_empty == 0 or bool((got[empty] != 0).any()):
        raise AssertionError("two_tower/ragged: no empty bag, or an empty bag not pooled to 0")
    del rag, scores, idx, wts, got, empty
    ub = make_bags(1, cfg.n_user_fields, cfg.n_users)
    n_cand = shapes["retrieval_cand"]["n_candidates"]
    cb = make_bags(n_cand, cfg.n_item_fields, cfg.n_items)
    model.score_candidates(ub, cb)  # warm-up
    t0 = sync_now()
    with counted(KERNELS, launches):
        cand = model.score_candidates(ub, cb)
    times["retrieval_ms"] = sync_s(t0) * 1e3
    expect_launches("embedding_bag", 2, "two_tower/retrieval_cand")
    if tuple(cand.shape) != (n_cand,) or not bool(torch.isfinite(cand).all()):
        raise AssertionError(f"two_tower/retrieval_cand: scores not finite of shape ({n_cand},)")
    torch.testing.assert_close(cand, plain_model.score_candidates(ub, cb),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    pair = model.serve_step({"user_bags": ub.expand(n_cand, -1, -1).contiguous(),
                             "item_bags": cb})
    torch.testing.assert_close(cand, pair, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    retrieval_event_ms = time_ms(lambda: model.score_candidates(ub, cb), reps=5)
    del pair, cand, plain_model
    # each tower's bag time against its MLP time, at serve_bulk
    bulk = serve["serve_bulk"]["batch"]
    tower_split = {}
    for tname, tower in model.tree().items():
        bags = bulk[f"{tname}_bags"]
        with torch.no_grad():  # serving: no autograd graph
            pooled = two_tower.pool_fields(tower, bags, cfg)
            tower_split[f"{tname}_bag_ms"] = time_ms(
                lambda: two_tower.pool_fields(tower, bags, cfg), reps=5)
            tower_split[f"{tname}_mlp_ms"] = time_ms(lambda: two_tower.mlp_head(tower, pooled),
                                                     reps=5)
        del pooled
    # the bag kernel at the serve_bulk user tower's operands
    idx = bulk["user_bags"].reshape(-1, kb)
    wts = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    got = bag_kernel.embedding_bag(table, idx, wts, "mean")
    ref = bag_kernel.embedding_bag_torch(table, idx, wts, "mean")
    torch.testing.assert_close(got, ref, rtol=0.0, atol=bag_atol)
    valid = idx >= 0
    n_valid = int(valid.sum())
    offsets = torch.cumsum(valid.sum(dim=1), 0) - valid.sum(dim=1)
    flat_ids = idx[valid].long()
    # the bound reads each distinct row once
    n_rows = int(torch.unique(flat_ids).numel())
    lib_fn = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        flat_ids, table, offsets, mode="mean")
    lib = lib_fn()
    torch.testing.assert_close(lib, got, rtol=0.0, atol=bag_atol)
    torch.testing.assert_close(lib, ref, rtol=0.0, atol=bag_atol)
    n_bags = idx.shape[0]
    bag_row = dict(
        name="embedding_bag", source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:61",
        shape=(f"V={table.shape[0]} D={table.shape[1]} B={n_bags} K={kb} valid={n_valid} "
               f"distinct={n_rows} mean"),
        max_abs_err=float((got - ref).abs().max()), tolerance=f"atol 2*K*K*2^-24*max|table| = {bag_atol:.3e}",
        ms=time_ms(lambda: bag_kernel.embedding_bag(table, idx, wts, "mean")),
        plain_ms=time_ms(lambda: bag_kernel.embedding_bag_torch(table, idx, wts, "mean"), reps=5),
        library_ms=time_ms(lib_fn),
        bytes=n_rows * table.shape[1] * 4 + idx.numel() * 8 + n_bags * table.shape[1] * 4,
        ops=2 * n_valid * table.shape[1],
    )
    say("two_tower", config=cfg.name, users=cfg.n_users, items=cfg.n_items,
        embed_dim=cfg.embed_dim, tower_mlp="-".join(map(str, cfg.tower_mlp)),
        tables_gb=f"{(model.user.table.numel() + model.item.table.numel()) * 4 / 1e9:.2f}",
        init_s=f"{init_s:.2f}", serve_p99_ms=f"{times['serve_p99_ms']:.3f}",
        serve_bulk_ms=f"{times['serve_bulk_ms']:.2f}", retrieval_ms=f"{times['retrieval_ms']:.2f}",
        serve_p99_event_ms=f"{serve['serve_p99']['event_ms']:.4f}",
        serve_p99_host_p50_ms=f"{p99_lat[0]:.4f}", serve_p99_host_p99_ms=f"{p99_lat[1]:.4f}",
        serve_bulk_event_ms=f"{serve['serve_bulk']['event_ms']:.4f}",
        retrieval_event_ms=f"{retrieval_event_ms:.4f}",
        **{k_: f"{v_:.4f}" for k_, v_ in tower_split.items()},
        bulk_user_valid_ids=n_valid, bulk_user_distinct_rows=n_rows,
        ragged_batch=RAGGED_BATCH, ragged_empty_user_bags=n_empty,
        library_embedding_bag_ms=f"{bag_row['library_ms']:.4f}",
        vs_plain_bag=f"rtol {SCORE_RTOL}, atol {SCORE_ATOL} (timed and ragged bags)",
        retrieval_vs_tiled_serve=f"rtol {SCORE_RTOL}, atol {SCORE_ATOL}",
        library_vs_kernel_and_plain="agree")
    del got, ref, lib, lib_fn, flat_ids, offsets, valid, wts, idx, table, bulk, serve, ub, cb
    del model
    torch.cuda.empty_cache()
    phase_s["two_tower_s"] = time.perf_counter() - p0

    # 11. transformer (h2o-danube-1.8b prefill and decode, full width) ---
    p0 = time.perf_counter()
    lm_cfg = dataclasses.replace(h2o_danube_1_8b.FULL, attn_impl="flash")
    lgen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = sync_now()
    lm = tm.init_model(lm_cfg, generator=lgen, device=dev)
    lm_init_s = sync_s(t0)
    n_layers, hq, hkv = lm_cfg.n_layers, lm_cfg.n_heads, lm_cfg.n_kv_heads
    dh, win = lm_cfg.head_dim, lm_cfg.sliding_window
    s_len = cfg_base.LM_SHAPES["prefill_32k"]["seq_len"]
    toks = torch.randint(0, lm_cfg.vocab, (PREFILL_BATCH, s_len), generator=lgen, device=dev)
    lm(toks)  # warm-up
    fa_paths = dict(fa_kernel.flash_attention.path_launches)
    t0 = sync_now()
    with counted(KERNELS, launches), largest_call(
            fa_ops, "attention", lambda args: args[0].numel()) as fa_seen:
        logits, _ = lm(toks)
    times["prefill_ms"] = sync_s(t0) * 1e3
    expect_launches("flash_attention", n_layers, "transformer/prefill")
    fa_paths = {k_: n_ - fa_paths[k_] for k_, n_ in fa_kernel.flash_attention.path_launches.items()}
    if fa_paths["wgmma"] != n_layers:
        raise AssertionError(f"transformer/prefill: flash_attention kernels {fa_paths}, expected "
                             f"all {n_layers} on the tensor-core (wgmma) kernel")
    if (tuple(logits.shape) != (PREFILL_BATCH, s_len, lm_cfg.vocab)
            or logits.dtype != lm_cfg.compute_dtype or not bool(torch.isfinite(logits).all())):
        raise AssertionError("transformer/prefill: logits not finite bfloat16 of shape "
                             f"({PREFILL_BATCH}, {s_len}, {lm_cfg.vocab})")
    del logits
    # the split: CUDA events around each kernel call of one more prefill
    fa_events = []
    fa_inner = fa_kernel.flash_attention

    def fa_timed(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fa_inner(*args, **kwargs)
        ev[1].record()
        fa_events.append(ev)
        return out

    # the wrapper counts on the name it is bound to
    fa_timed.launches = 0
    fa_timed.path_launches = dict.fromkeys(fa_kernel.PATHS, 0)

    whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    fa_kernel.flash_attention = fa_timed
    try:
        whole[0].record()
        lm(toks)
        whole[1].record()
    finally:
        fa_kernel.flash_attention = fa_inner
    torch.cuda.synchronize()
    prefill_event_ms = whole[0].elapsed_time(whole[1])
    attn_event_ms = sum(a.elapsed_time(b_) for a, b_ in fa_events)
    pairs = fa_kernel.visible_pairs(s_len, s_len, True, win)
    matmul_params = lm_cfg.n_params() - lm_cfg.vocab * lm_cfg.d_model - (2 * n_layers + 1) * lm_cfg.d_model
    proj_flop = 2 * matmul_params * PREFILL_BATCH * s_len
    attn_flop = n_layers * PREFILL_BATCH * hq * 4 * dh * pairs
    say("transformer", config=lm_cfg.name, attn_impl=lm_cfg.attn_impl, layers=n_layers,
        d_model=lm_cfg.d_model, heads=f"{hq}/{hkv}", d_head=dh, window=win,
        params=lm_cfg.n_params(), init_s=f"{lm_init_s:.2f}", prefill_tokens=s_len,
        prefill_batch=f"{PREFILL_BATCH} (prefill_32k's 32 cut to 1)",
        prefill_ms=f"{times['prefill_ms']:.2f}",
        prefill_tokens_per_s=f"{PREFILL_BATCH * s_len / times['prefill_ms'] * 1e3:.1f}",
        model_tflop=f"{proj_flop / 1e12:.2f}+{attn_flop / 1e12:.2f}",
        model_flop_share_of_989=f"{(proj_flop + attn_flop) / (times['prefill_ms'] / 1e3) / TENSOR_BF16_OPS_PER_S:.4f}",
        prefill_event_ms=f"{prefill_event_ms:.2f}", flash_calls=len(fa_events),
        flash_event_ms=f"{attn_event_ms:.2f}", rest_event_ms=f"{prefill_event_ms - attn_event_ms:.2f}",
        flash_share=f"{attn_event_ms / prefill_event_ms:.4f}",
        flash_kernels=",".join(f"{k_}:{n_}" for k_, n_ in fa_paths.items()), card=f"'{smi}'")
    # the kernel at one layer's operands, against its plain version
    fq, fk_, fv = (t.contiguous() for t in fa_seen["args"])
    got = fa_kernel.flash_attention(fq, fk_, fv, causal=True, window=win)
    ref = fa_kernel.flash_attention_torch(fq, fk_, fv, causal=True, window=win)
    fa_atol = 2.0**-12 * float(fv.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0**-7, atol=fa_atol)
    fa_row = dict(
        name="flash_attention", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:81",
        shape=(f"q {list(fq.shape)} k/v {list(fk_.shape)} bf16 causal window {win}, "
               f"{pairs} visible pairs a head"),
        max_abs_err=float((got.float() - ref.float()).abs().max()),
        tolerance=(f"rtol 2^-7 (one bfloat16 rounding), atol 2^-12*max|v| = {fa_atol:.3e} "
                   "(f32 sums of <= 4096 terms in two orders)"),
        ms=time_ms(lambda: fa_kernel.flash_attention(fq, fk_, fv, causal=True, window=win)),
        plain_ms=time_ms(lambda: fa_kernel.flash_attention_torch(fq, fk_, fv, causal=True,
                                                                 window=win), reps=3),
        library_ms=None,
        bytes=(fq.numel() * 2 + fk_.numel() * 2) * fq.element_size(),
        ops=fq.shape[0] * hq * 4 * dh * pairs,
        ops_per_s=TENSOR_BF16_OPS_PER_S, peak="bf16 tensor cores, 989 TFLOP/s",
    )
    # where the kernel and its plain version round an output to different
    # bfloat16 neighbours, against the FMA kernel (float32 on the same
    # bfloat16 values, rounded once: what it computes for bfloat16 inputs)
    fma = fa_kernel.flash_attention(fq.float(), fk_.float(), fv.float(), causal=True,
                                    window=win).bfloat16()
    # (an output near 0 may change sign inside the atol: many ulps apart)
    flips_note = []
    for name_, out_ in (("wgmma", got), ("fma", fma)):
        u = bf16_ulps(out_, ref)
        far = (u > 1) & ((out_.float() - ref.float()).abs() > fa_atol)
        flips_note.append(f"{name_} {float((u > 0).float().mean()):.4e} of outputs "
                          f"({int(far.sum())} beyond one ulp and the atol)")
    flips_note = ", ".join(flips_note)
    del got, fma, u, far
    sass = flash_sass(_build.library()._name, _build._nvcc())
    if (not sass["tc80"]["HGMMA"] or not sass["tc80"]["UTMALDG"]
            or sass["fma"]["HGMMA"] or sass["fma"]["HMMA"]):
        raise AssertionError(f"transformer: flash_attention SASS {sass}: expected HGMMA and "
                             "UTMALDG in the D = 80 bfloat16 kernel, none in the FMA kernels")
    try:  # the yardstick only: PyTorch's SDPA with the explicit mask
        from torch.nn.attention import SDPBackend, sdpa_kernel
        kr = fk_.repeat_interleave(hq // hkv, dim=1)
        vr = fv.repeat_interleave(hq // hkv, dim=1)
        ids = torch.arange(s_len, device=dev)
        mask = (ids[None, :] <= ids[:, None]) & (ids[None, :] > ids[:, None] - win)
        lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            fq, kr, vr, attn_mask=mask)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_err = float((lib_fn().float() - ref.float()).abs().max())
            fa_row["library_ms"] = time_ms(lib_fn, reps=5)
        lib_note = (f"F.scaled_dot_product_attention (EFFICIENT_ATTENTION, bool mask, K/V "
                    f"repeated; the full S^2 work, {4 * hq * dh * s_len * s_len / 1e12:.2f} "
                    f"TFLOP), max abs diff vs plain {lib_err:.3e}")
        del kr, vr, mask
    except (RuntimeError, NotImplementedError) as e:
        lib_note = f"none: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    # what a tuned library reaches at head dim 80 on this card: SDPA's flash
    # backend on plain causal attention (no window, K/V repeated, its own
    # S(S+1)/2 pairs a head); a yardstick only, never on the port's path
    causal_flop = 4 * dh * hq * s_len * (s_len + 1) // 2
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        kr = fk_.repeat_interleave(hq // hkv, dim=1)
        vr = fv.repeat_interleave(hq // hkv, dim=1)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            causal_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                fq, kr, vr, is_causal=True), reps=5)
        causal_note = (f"sdpa_flash_causal_ms={causal_ms:.4f} "
                       f"sdpa_flash_causal_tflops={causal_flop / causal_ms / 1e9:.1f}")
        del kr, vr
    except (RuntimeError, NotImplementedError) as e:
        causal_note = f"none: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    fa_tflops = fa_row["ops"] / fa_row["ms"] / 1e9
    say("transformer", kernel_ms=f"{fa_row['ms']:.4f}", plain_ms=f"{fa_row['plain_ms']:.4f}",
        kernel_tflops_visible=f"{fa_tflops:.1f}",
        kernel_share_of_989=f"{fa_tflops * 1e12 / TENSOR_BF16_OPS_PER_S:.4f}",
        library=lib_note, causal_yardstick=causal_note, flips_vs_plain=flips_note,
        sass=" ".join(f"{fn_}:" + ",".join(f"{op}={n_}" for op, n_ in c.items())
                      for fn_, c in sass.items()))
    del ref, fq, fk_, fv, fa_seen
    torch.cuda.empty_cache()
    # the model against its plain attention, window active: held in
    # float32; in bfloat16 printed, and held against the float32 model
    # beside the bfloat16 model with the plain attention
    short = toks[:, :LM_CHECK_LEN]
    lm_check = {}
    for name, model in (("f32", lm.with_config(compute_dtype=torch.float32)), ("bf16", lm)):
        got, _ = model(short)
        ref, _ = model.with_backend("torch")(short)
        diff = (got.float() - ref.float()).abs()
        lm_check |= {f"{name}_max_abs_diff": f"{float(diff.max()):.3e}",
                     f"{name}_share_differing": f"{float((diff > 0).float().mean()):.3e}",
                     f"{name}_beyond_2^-4": int((diff > 2.0**-4 * (1 + ref.float().abs())).sum()),
                     f"{name}_argmax_agree":
                         f"{float((got.argmax(-1) == ref.argmax(-1)).float().mean()):.6f}"}
        if name == "f32":
            torch.testing.assert_close(got, ref, rtol=LM_CHECK_TOL, atol=LM_CHECK_TOL)
            exact = ref
        else:
            rms = {k_: float((x.float() - exact).square().mean().sqrt())
                   for k_, x in (("kernel", got), ("plain", ref))}
            agree = {k_: float((x.argmax(-1) == exact.argmax(-1)).float().mean())
                     for k_, x in (("kernel", got), ("plain", ref))}
            lm_check |= {
                "bf16_rms_vs_f32": f"{rms['kernel']:.4e}",
                "bf16_plain_rms_vs_f32": f"{rms['plain']:.4e}",
                "bf16_rms_ratio": f"{rms['kernel'] / rms['plain']:.4f}",
                "bf16_argmax_agree_f32": f"{agree['kernel']:.6f}",
                "bf16_plain_argmax_agree_f32": f"{agree['plain']:.6f}"}
            if rms["kernel"] > LM_BF16_RMS_RATIO * rms["plain"]:
                raise AssertionError(
                    f"transformer: the bfloat16 model's logits are {rms['kernel']:.4e} RMS from "
                    f"the float32 model's through the kernel, {rms['plain']:.4e} through the "
                    f"plain attention (limit {LM_BF16_RMS_RATIO}x)")
        del got, ref, diff
    del toks, short, exact
    # decode_32k: batch 128 against the ring, filled from the seed
    dec = cfg_base.LM_SHAPES["decode_32k"]
    db = dec["global_batch"]
    shapes = tm.cache_shapes(lm_cfg, db, dec["seq_len"])
    cache = {"k": torch.empty_like(shapes["k"], device=dev),
             "v": torch.empty_like(shapes["v"], device=dev), "pos": dec["seq_len"]}
    for buf in (cache["k"], cache["v"]):
        for layer in buf:
            layer.normal_(generator=lgen)
    cache_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    tok = torch.randint(0, lm_cfg.vocab, (db, 1), generator=lgen, device=dev)
    out, cache = lm.decode_step(cache, tok)  # warm-up
    tok = out.argmax(-1)
    t0 = sync_now()
    with counted(KERNELS, launches):
        for _ in range(DECODE_STEPS):
            out, cache = lm.decode_step(cache, tok)
            tok = out.argmax(-1)
    times["decode_step_ms"] = sync_s(t0) * 1e3 / DECODE_STEPS
    if tuple(out.shape) != (db, 1, lm_cfg.vocab) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"transformer/decode: logits not finite of shape ({db}, 1, "
                             f"{lm_cfg.vocab})")
    if cache["pos"] != dec["seq_len"] + DECODE_STEPS + 1:
        raise AssertionError(f"transformer/decode: pos {cache['pos']} after the steps")
    ring = cache["k"].shape[3]
    # the step's plain attention alone, at one layer's shapes
    dq = torch.randn((db, hq, 1, dh), generator=lgen, device=dev).to(lm_cfg.compute_dtype)
    dec_attn_ms = time_ms(lambda: tattn.decode_attention(dq, cache["k"][0], cache["v"][0], ring),
                          reps=5)
    del cache, out, tok, dq
    torch.cuda.empty_cache()
    # prefill against decode in float32 (forward through the kernel)
    f32 = lm.with_config(compute_dtype=torch.float32)
    ptoks = torch.randint(0, lm_cfg.vocab, (PD_BATCH, PD_LEN), generator=lgen, device=dev)
    full, _ = f32(ptoks)
    pc = tm.init_cache(lm_cfg, PD_BATCH, PD_LEN, device=dev)
    for i in range(PD_LEN):
        last, pc = f32.decode_step(pc, ptoks[:, i:i + 1])
    torch.testing.assert_close(last[:, 0], full[:, -1], rtol=PD_TOL, atol=PD_TOL)
    pd_diff = float((last[:, 0] - full[:, -1]).abs().max())
    del f32, full, pc, last, lm
    torch.cuda.empty_cache()
    say("transformer", decode_batch=db, ring_slots=ring, pos=dec["seq_len"],
        cache_gb=f"{cache_gb:.2f}", decode_steps=DECODE_STEPS,
        decode_step_ms=f"{times['decode_step_ms']:.2f}",
        decode_tokens_per_s=f"{db / times['decode_step_ms'] * 1e3:.1f}",
        decode_attention_ms_a_layer=f"{dec_attn_ms:.4f}",
        decode_attention_share=f"{n_layers * dec_attn_ms / times['decode_step_ms']:.4f}",
        **{f"vs_plain_{k_}": v_ for k_, v_ in lm_check.items()},
        vs_plain_tolerance=(f"float32: rtol=atol={LM_CHECK_TOL} at {LM_CHECK_LEN} tokens; "
                            f"bfloat16: RMS from float32 <= {LM_BF16_RMS_RATIO}x the plain's"),
        prefill_vs_decode_max_abs_diff=f"{pd_diff:.3e}",
        prefill_vs_decode=f"float32, {PD_LEN} tokens x {PD_BATCH}, rtol=atol={PD_TOL}")
    phase_s["transformer_s"] = time.perf_counter() - p0

    say("main_path", **{f"{k}_launches": v_ for k, v_ in launches.items()})
    missing = [k for k, v_ in launches.items() if v_ == 0 and k not in OFF_PATH]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")

    # small input against the dense oracle, through the same entry points
    small = synthetic.make_graph("social", scale=10, edge_factor=8, seed=7, device=dev)
    sg = DiGraph.from_csr(small, device=dev)
    srng = np.random.default_rng(7)
    sg.apply(updates.plan_update(
        inserts=edgebatch.random_insertions(srng, small.n, 300),
        deletes=edgebatch.random_deletions(srng, small, 300),
    ))
    exp = traversal.reverse_walk_dense_oracle(sg.to_csr().to_dense(), 6)
    got = util.host(sg.reverse_walk(6))
    np.testing.assert_allclose(got, exp[: got.shape[0]], rtol=WALK_RTOL)
    snv = sg.n_max_vertex() + 1
    got = util.host(traversal.reverse_walk_slotted(sg.dst, sg.slot_rows, 6, snv))
    np.testing.assert_allclose(got, exp[:snv], rtol=1e-4)
    rs, rd, _, rsn = synthetic.make_coo("road", scale=10, seed=7, weighted=False)
    rc = csr.from_coo(rs, rd, n=rsn, device=dev)
    got = util.host(bsr_ops.reverse_walk_bsr(bsr_ops.csr_to_bsr(rc), 6, rsn))
    np.testing.assert_allclose(
        got, traversal.reverse_walk_dense_oracle(rc.to_dense(), 6), rtol=1e-5)
    rows_s = util.expand_rows(small.offsets, small.m)
    h_s = np.random.default_rng(7).standard_normal((small.n, 5)).astype(np.float32)
    exp_s = np.zeros((small.n, 5))
    np.add.at(exp_s, util.host(rows_s), h_s[util.host(small.dst)].astype(np.float64))
    got_s = seg_ops.edge_segment_sum(rows_s, torch.from_numpy(h_s).to(dev)[small.dst.long()],
                                     num_segments=small.n)
    np.testing.assert_allclose(util.host(got_s), exp_s, rtol=1e-5, atol=1e-5)
    smoke_cfg = two_tower_retrieval.SMOKE
    sm = two_tower.init_model(smoke_cfg, generator=torch.Generator(dev).manual_seed(7),
                              device=dev)
    host = lambda t_: t_.detach().cpu()  # noqa: E731
    sm_cpu = two_tower.TwoTower(tree.tree_map(host, sm.tree()), smoke_cfg)
    brng = np.random.default_rng(7)
    sbatch = {f"{t}_bags": torch.from_numpy(brng.integers(
        -1, smoke_cfg.n_users, (32, nf, smoke_cfg.bag_size)).astype(np.int32))
        for t, nf in (("user", smoke_cfg.n_user_fields), ("item", smoke_cfg.n_item_fields))}
    np.testing.assert_allclose(
        util.host(sm.serve_step({k_: v_.to(dev) for k_, v_ in sbatch.items()})),
        util.host(sm_cpu.serve_step(sbatch)), rtol=SCORE_RTOL, atol=SCORE_ATOL)
    lm_smoke = dataclasses.replace(h2o_danube_1_8b.SMOKE, attn_impl="flash", attn_block=8)
    slm = tm.init_model(lm_smoke, generator=torch.Generator(dev).manual_seed(7), device=dev)
    slm_cpu = tm.TransformerLM(tree.tree_map(host, slm.tree()),
                               dataclasses.replace(lm_smoke, attn_impl="ref"))
    stoks = torch.from_numpy(np.random.default_rng(7).integers(0, lm_smoke.vocab, (2, 48)))
    np.testing.assert_allclose(util.host(slm(stoks.to(dev))[0]), util.host(slm_cpu(stoks)[0]),
                               rtol=1e-4, atol=1e-4)
    say("reference", graphs="social scale 10 (image and slotted walks), road scale 10 (BSR)",
        steps=6, dense_oracle="agrees", segment_sum="numpy float64 sums agree (rtol 1e-5)",
        two_tower="SMOKE on the card agrees with the same weights on the CPU",
        transformer="SMOKE (flash on the card) agrees with the dense reference on the CPU "
                    "(rtol 1e-4, atol 1e-4)")

    # 12. kernels against their plain versions at the main path's shapes --
    gidx = sw_ops._prep_gidx(g.dst, nv, img.edges_hi())
    vals = torch.cat([vk, vk.new_zeros(1)]).index_select(0, gidx.reshape(-1))
    vals = vals.reshape(-1, sw_kernel.EB).contiguous()
    src_d = torch.from_numpy(src.astype(np.int32)).to(dev)
    rows = []

    got, ref = sw_kernel.tile_cumsum(vals), sw_kernel.tile_cumsum_torch(vals)
    err = (got - ref).abs()
    tol = 1e-5 * ref.abs() + 1e-6 * ref.abs().amax(dim=1, keepdim=True)
    if not bool((err <= tol).all()):
        raise AssertionError("tile_cumsum: kernel disagrees with its plain version")
    nbytes = vals.numel() * 4 * 2
    rows.append(dict(
        name="tile_cumsum", source="src/repro_torch/csrc/tile_cumsum.cu",
        replaces="src/repro/kernels/slot_walk/kernel.py:43",
        shape=f"[{vals.shape[0]},{vals.shape[1]}] f32",
        max_abs_err=float(err.max()), tolerance="rtol 1e-5, atol 1e-6*tile max",
        ms=time_ms(lambda: sw_kernel.tile_cumsum(vals)),
        plain_ms=time_ms(lambda: sw_kernel.tile_cumsum_torch(vals)),
        library_ms=time_ms(lambda: torch.cumsum(vals, dim=-1)),
        bytes=nbytes, ops=vals.numel(),
    ))
    # the batched walk's tile bases: SERVE_BATCH planes of the walk's tiles
    incl = (sw_kernel.tile_cumsum(vals).reshape(1, -1)
            * torch.arange(1, SERVE_BATCH + 1, dtype=torch.float32, device=dev).unsqueeze(1))
    rows.append(tile_bases_row(sw_kernel, incl))
    del incl
    # the batched walk's gather: SERVE_BATCH rows of visits at the walk's index
    v16 = torch.rand((SERVE_BATCH, nv), generator=torch.Generator(dev).manual_seed(SEED),
                     device=dev)
    rows.append(slot_gather_row(sw_kernel, v16, gidx, "the batched walk"))
    del v16

    # the mixed batch's largest merge launch, from the arena it read: in
    # place against the plain version, bit for bit; timed in place, each
    # call on a fresh copy of that arena (copied outside its timed span)
    m_dst, m_wgt, m_rows, (w, a, k, d_k, moves, host_ops), m_lo, m_hi = merge_case
    row_ops, bdl, bw = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in host_ops)
    clone = lambda t_: None if t_ is None else t_.clone()  # noqa: E731
    fresh = lambda: [clone(t_) for t_ in (m_dst, m_wgt, m_rows, m_lo, m_hi)]  # noqa: E731

    def merge(fn, out, **kw):
        counts = fn(*out[:3], row_ops, bdl, bw, width=w, moves=moves, lo=out[3], hi=out[4],
                    **kw)
        return out + [counts]

    out_k = merge(su_kernel.merge_rows_fused, fresh())
    out_p = merge(su_kernel.merge_rows_fused_torch, fresh(), max_holes=d_k)
    mism = sum(int((x_ != y_).sum()) for x_, y_ in zip(out_k, out_p) if x_ is not None)
    if mism:
        raise AssertionError(f"merge_rows_fused: {mism} elements differ from the plain version")
    del out_k, out_p
    old_st, old_cap, new_st, new_cap, degs, row_ids = host_ops[0].astype(np.int64)
    real = new_st >= 0
    moved = (old_st >= 0) & (new_st != old_st)
    n_real = int(real.sum())
    lohi_bytes = int((row_ids[real] < m_lo.shape[0]).sum()) * 8 if m_lo is not None else 0
    # the function's bytes: real rows' row_ops, live prefixes, runs and
    # counts, their new blocks, the owner map over moved rows' new blocks,
    # the cleared old blocks, [lo, hi)
    merge_bytes = (n_real * (24 + k * 12 + 4) + int(degs[real].sum()) * 8
                   + int(new_cap[real].sum()) * 8 + int(old_cap[moved].sum()) * 4
                   + (int(new_cap[moved].sum()) * 4 if moves else 0) + lohi_bytes)
    # what the kernel moves: every row's row_ops, run and count, the owner
    # map over every real row's new block
    kernel_bytes = (a * (24 + k * 12 + 4) + int(degs[real].sum()) * 8
                    + int(new_cap[real].sum()) * (12 if moves else 8)
                    + int(old_cap[moved].sum()) * 4 + lohi_bytes)
    say("merge_rows_fused", rows=a, real_rows=n_real, moved_rows=int(moved.sum()),
        function_bytes=merge_bytes, kernel_bytes=kernel_bytes,
        kernel_over_function=f"{kernel_bytes / merge_bytes:.4f}")
    rows.append(dict(
        name="merge_rows_fused", source="src/repro_torch/csrc/merge_rows.cu",
        replaces="src/repro/kernels/slot_update/kernel.py:108",
        shape=f"A={a} W={w} K={k} (rows {n_real}, moved {int(moved.sum())})",
        max_abs_err=0.0, tolerance="bit-exact (arena, owner map, [lo, hi), counts)",
        ms=time_fresh_ms(fresh, lambda o: merge(su_kernel.merge_rows_fused, o)),
        plain_ms=time_fresh_ms(
            fresh, lambda o: merge(su_kernel.merge_rows_fused_torch, o, max_holes=d_k), reps=5),
        library_ms=None, bytes=merge_bytes, ops=n_real * (w + k),
    ))
    del merge_case, m_dst, m_wgt, m_rows

    # the load path's sorted sources (sorting ids is unique, so these are
    # the build's src_s), against the plain version and the histogram
    src_s = torch.sort(src_d).values
    off_k, off_p = cb_kernel.degree_offsets(src_s, n), cb_kernel.degree_offsets_torch(src_s, n)
    mism = int((off_k != off_p).sum())
    if mism:
        raise AssertionError(f"degree_offsets: {mism} offsets differ from the plain version")
    got, ref = cb_kernel.count_degrees(src_d, n), cb_kernel.count_degrees_torch(src_d, n)
    mism = int((got != ref).sum())
    if mism:
        raise AssertionError(f"count_degrees: {mism} vertices differ from the plain version")
    if not torch.equal(off_k[1:] - off_k[:-1], ref):
        raise AssertionError("degree_offsets: the offsets' differences are not the histogram")
    if not torch.equal(cb_kernel.degree_offsets(src_s, n), off_k):
        raise AssertionError("degree_offsets: a second call gave other bits")
    del off_k, off_p
    rows.append(dict(
        name="degree_offsets", source="src/repro_torch/csrc/count_degrees.cu",
        replaces="src/repro/kernels/csr_build/kernel.py:47",
        shape=f"M={src_s.shape[0]} n={n} sorted", max_abs_err=0.0,
        tolerance="bit-exact (and its differences equal the histogram)",
        ms=time_ms(lambda: cb_kernel.degree_offsets(src_s, n)),
        plain_ms=time_ms(lambda: cb_kernel.degree_offsets_torch(src_s, n), reps=5),
        library_ms=time_ms(lambda: torch.searchsorted(
            src_s, torch.arange(n + 1, dtype=torch.int32, device=dev), out_int32=True), reps=5),
        bytes=src_s.numel() * 4 + (n + 1) * 4, ops=src_s.numel(),
    ))
    del src_s
    rows.append(dict(
        name="count_degrees", source="src/repro_torch/csrc/count_degrees.cu",
        replaces="src/repro/kernels/csr_build/kernel.py:47",
        shape=f"M={src_d.shape[0]} n={n}", max_abs_err=0.0, tolerance="bit-exact",
        ms=time_ms(lambda: cb_kernel.count_degrees(src_d, n)),
        plain_ms=time_ms(lambda: cb_kernel.count_degrees_torch(src_d, n)),
        library_ms=time_ms(lambda: torch.bincount(src_d, minlength=n)),
        bytes=src_d.numel() * 4 + n * 4, ops=src_d.numel(),
    ))

    got, ref = (sw_kernel.slot_walk_partials(sw_rows, sw_vals, nv),
                sw_kernel.slot_walk_partials_torch(sw_rows, sw_vals, nv))
    if not torch.equal(got[1], ref[1]):
        raise AssertionError("slot_walk_partials: rank_rows differ from the plain version")
    torch.testing.assert_close(got[0], ref[0], rtol=PARTIALS_RTOL, atol=0.0)
    nz = ref[0] != 0
    rows.append(dict(
        name="slot_walk_partials", source="src/repro_torch/csrc/slot_walk_partials.cu",
        replaces="src/repro/kernels/slot_walk/kernel.py:83",
        shape=f"[{sw_rows.shape[0]},{sw_rows.shape[1]}] i32+f32",
        max_abs_err=float((got[0] - ref[0]).abs().max()),
        max_rel_err=float(((got[0] - ref[0]).abs()[nz] / ref[0][nz]).max()),
        tolerance="rank_rows bit-exact, partials rtol 254*2^-24",
        ms=split["partials_ms"],
        plain_ms=time_ms(lambda: sw_kernel.slot_walk_partials_torch(sw_rows, sw_vals, nv)),
        library_ms=None,
        bytes=sw_rows.numel() * 16, ops=sw_rows.numel(),
    ))
    del got, ref, nz
    rows += [road_gather_row, bsr_row, seg_row, bag_row, fa_row]

    kernels = []
    for r in rows:
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops"] / r.get("ops_per_s", VECTOR_OPS_PER_S) * 1e3
        peak = ("HBM 3.35 TB/s" if bytes_ms >= ops_ms
                else r.get("peak", "float32 non-tensor, 67 TFLOP/s"))
        say("kernel", name=r["name"], shape=r["shape"], launches=launches[r["name"]],
            max_abs_err=r["max_abs_err"], tolerance=r["tolerance"],
            **({"max_rel_err": f"{r['max_rel_err']:.3e}"} if "max_rel_err" in r else {}),
            ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            library_ms="none" if r["library_ms"] is None else f"{r['library_ms']:.4f}",
            bound_ms=f"{max(bytes_ms, ops_ms):.4f}", bound_peak=peak)
        kernels.append(dict(
            name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
            launches=launches[r["name"]], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations", bound_peak=peak,
            library_ms=r["library_ms"],
        ))
    say("main_path_ms", **{k: f"{v_:.2f}" for k, v_ in times.items()})
    say("wall", total_s=f"{time.perf_counter() - start:.1f}",
        **{k: f"{v_:.1f}" for k, v_ in phase_s.items()})

    # 13. result lines ---------------------------------------------------
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
