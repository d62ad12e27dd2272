#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, PyTorch built for
CUDA and ``nvcc``.  Phases, one JSON line each:

1. card         the GPU's name and power limit (nvidia-smi);
2. build        compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels      hold each kernel against its plain PyTorch version at the
                main paths' shapes and at ragged and small ones, and time
                the kernel (CUDA events, and the host clock per call over
                the same loop: enqueue_ms), the plain version and, where
                one exists, the PyTorch library call that computes the
                same function; the two host-bound kernels (gradip_flat,
                fixture_double) in turns with their library call, with
                the host time of their wrappers' pieces, fused_update in
                turns with torch.add, the flash forward in turns with
                SDPA's f32 forward and the flash backward pair (dQ +
                dK/dV) with SDPA's f32 backward, the flash kernels against
                both their f32 and their 3xTF32 bound, with their record
                of their blocks and their one-pass TF32 control; rows 3,
                5-6 and 7 also at Qwen3-4B's and ChatGLM3-6B's shapes,
                rows 3 and 7 at the serving shapes of Jamba (G 8) and
                Whisper (G 1, head_dim 64), row 8 at a [2, 1536, 16384]
                serving prefill with ragged lengths, rows 1 and 2 also
                at phases lora's and slice_qwen3's flat sizes, and row 4
                at their GradIP sizes;
4. slice        MEERKAT-VP on full-size Llama-3.2-1B (random weights from a
                seed): sensitivity mask and pre-training gradient through
                the flash kernels' backward, held against the dense
                attention route (the whole-model gradient and the mask), VP
                calibration, three federated rounds of eight Dirichlet
                clients, evaluation before and after, and one client's
                trajectory against the server's replay; then one more ZO
                step under torch.profiler;
4b. fleet       fleet rounds with faults and checkpoint/resume on the same
                model: the sensitivity mask and pre-training gradient,
                then 16 Dirichlet clients (batch 16, T=2), a cohort of 8 a
                round (ClientSampler), the int8 uplink, a FaultPlan of
                drops and stragglers and GradIP every round; the server
                runs 2 rounds, checkpoints (4.94 GB, the port's own
                MessagePack codec), runs 2 more; a fresh server restores
                the file and runs the last 2: parameters, GradIP log,
                bytes, straggler queue, sampler, pointers and round info
                bit-equal; every upload billed at the int8 wire size; one
                client's applied scalars equal the server's decoded wire
                and its delta the wire replay;
4f. mesh        the sharded federated round (sharding/fl.FLShardPlan) on
                the slice's problem: one NCCL rank, a 1x1 mesh; VP
                calibration (T_cali 2) and 2 rounds unsharded and under
                FSDP from the same state (parameters after each round,
                GradIP log, flags, bytes and pointers bit-equal, rows 1-4
                launched as often), 1 round under "replicate" (bit-equal),
                the FSDP server's checkpoint restored into an unsharded
                server and one more round each (bit-equal); the round
                seconds of each route, the gather at round entry, the
                peak; make_fl_train_loop (8 x 2 x 512, 2 steps) on the mesh
                route within 2e-5 / 2e-4 of the unsharded one; then the
                roofline line: one client's ZO step timed against its model
                FLOPs (launch/roofline.step_model_flops) over the f32 peak;
4g. tp          tensor-parallel compute (rule="tp") on the slice's problem,
                one NCCL rank, a 1x1 mesh: 2 rounds of 8 clients (T=1)
                unsharded and under tp from the same state, the tp model
                under the plan's ctx as the train CLI builds it
                (parameters after each round bit-equal, else within 2e-5;
                rows 1-2 on each rank's flat shards and row 3 on its
                local heads, each launched as often as unsharded);
                Phi-3.5-MoE's layer (1 of
                32, full width) through moe_sharded against moe_dense_ref
                on 4 x 512 tokens (1e-5); the dry run's own ZO step run
                for real (time, device-memory rise); then the dryrun line:
                that step's fake-group record (f32, 16 x 512, 1x1) against
                the real run (peak_est less arguments within 10% of the
                rise), its FLOPs against step_model_flops, its roofline
                bound at the f32 peak against the step's time; and bf16
                single-mesh records of qwen3-4b train_4k and kimi-k2
                decode_32k (depth 1/2, extrapolated), with their seconds;
4c. lora        LoRA-FedZO on the same model with rank-4 adapters on q and
                v (alpha 16; 425,984 coordinates, LoRASpace on the flat
                kernel route over all 1,236,240,384 parameters): the fresh
                LoRA model's loss bit-equal to the base model's, the
                pre-training gradient at the adapters through the flash
                backward, two clients early-stopped by early_stop_random,
                two rounds of eight Dirichlet clients at T=2 with GradIP;
                every base weight bit-equal after them, the flagged
                clients at one step, bytes, evaluation, one client's
                trajectory against the server's replay;
4d. slice_qwen3 MEERKAT on Qwen3-4B at full width (qk-norm, head_dim 128,
                G 4), 8 of 36 layers (1.59 B parameters): the slice's mask
                and pre-training gradient with their dense-route checks,
                two rounds of eight clients with GradIP (no VP
                calibration), evaluation, the replay; one ZO step under
                torch.profiler;
4e. options     ChatGLM3-6B (partial RoPE, QKV bias, G 16; 2 of 28 layers)
                and Phi-3.5-MoE (LayerNorm, 16 experts top-2; 1 of 32
                layers) at full width: the logits and the LM loss of
                2 x 1024 on the kernel, online and dense (q-block 256)
                routes, within their bounds of the kernel route's, the
                launches counted across the three (the online and dense
                routes launch none); ChatGLM3 behind the engine (prompts of 1024 and 300,
                16 greedy tokens on the flash-decode kernel at G 16) with
                the serve checks, and every token the argmax of the
                teacher-forced training forward;
5. first_order  the backprop baseline on the same model: two Adam steps
                (``make_train_step``) and one FedAvg round of eight
                Dirichlet clients (``fedavg_round``); then one more Adam
                step under torch.profiler;
6. serve        serving on the same model: the continuous-batching engine
                (8 slots, 2048 positions) over 24 requests of 32-1536
                prompt tokens, greedy, its waves and bursts CUDA graphs;
                every token held against the request replayed alone, the
                kernel and ref decode routes against each other, and the
                naive engine on 8 of the requests; then one decode burst
                under torch.profiler, replayed and eager;
7. serve_gemma  Gemma-2-2b at full width, 2 periods (4 layers): one prompt
                past the 4096-position window (rolling local cache) and one
                short one, prefilled together through the flash forward at
                head_dim 256, with the same checks but the naive engine's;
7b. grad_gemma  the same model under autograd: the sensitivity mask and
                one pre-training gradient of 1 x 4352 tokens (past the
                window) through the flash kernels' backward at head_dim
                256, held against the dense attention route (per-leaf
                gradient, mask overlap);
8. slice_jamba  MEERKAT-VP on Jamba-1.5-Large at full width, cut to 4
                layers (attention + 3 Mamba, no experts: 4.9 B parameters):
                mask and pre-training gradient (the Mamba layers on the
                differentiable scan route, attention through the flash
                kernels), VP calibration, two rounds of eight Dirichlet
                clients on the ZO tree route, every forward's Mamba layers
                through the selective-scan kernel; one client's delta
                against the server's replay, and the kernel route's logits
                against the scan route's; then one ZO step under
                torch.profiler;
9. jamba_moe    one (Mamba, MoE) layer of Jamba-1.5-Large at full width (16
                experts of 24576, top 2, 11.2 B parameters): a forward and
                the LM loss, finite; then the layer's MoE FFN on its real
                input against a plain per-token loop (moe_loop_ref), at the
                configured capacity and at one that drops pairs;
9b. serve_jamba one period of Jamba-1.5-Large at full width, (attention,
                dense) and (Mamba, MoE), 11.9 B parameters, behind the
                continuous-batching engine (4 slots, 2048 positions, six
                greedy requests of 1-1500 tokens, waves admitted
                mid-decode): every token against the request replayed
                alone, the kernel and ref decode routes over 4 steps, the
                first wave's prefill Mamba cache on the kernel route (the
                selective scan, dt zeroed past each row's length) against
                the scan route, one decode step with inactive rows that
                must stay bit-equal; the decode step beside its floor of
                streaming every weight;
9c. families    xLSTM-350m at full size: two MEERKAT rounds of eight
                Dirichlet clients at T=1 with GradIP and the replay check
                (no attention layer: no dense-route check, its mask
                overlap and gradient gap printed as null); then xLSTM-350m, Whisper-small (12 + 12 layers, 1500
                frames) and Pixtral-12b at full width (2 of 40 layers, 256
                patch positions), each held to its training forward
                (prefill of 299 tokens and one decode step) and served
                behind the engine with the serve checks (zero frontend
                stubs, as the JAX package's engines);
9d. examples    the five ``examples/*_torch.py`` in this process at CI's
                smoke sizes (EXAMPLE_ARGV): quickstart (8 rounds; 4 bytes
                a client a step uploaded, one client's step against the
                server's replay), train_e2e (--large: llama-110m, VP
                calibration, 2 rounds of T=2, its checkpoint read back
                bit-equal), vpcs_demo (60 steps), serve_batch (three
                reduced archs behind the engine's CUDA graphs; a second
                pass of the same prompts gives the same tokens) and
                mesh_round (1x1, one NCCL rank; bit-equal to unsharded):
                each one's seconds, launches per row (rows 1, 2 and 4 as
                its steps imply) and check, and a failure where a row its
                path reaches (EXAMPLE_ROWS) launched no time; then the
                hlo_tools line: ``repro_torch.launch.hlo_tools`` on
                qwen2-7b x decode_32k at depth 1 on the fake 16x16 group
                (op totals, the top 5);
10. analysis    the static analyzer (``repro_torch.analysis``) on the card:
                every rule flags its bad fixtures and passes its good ones
                (the fixture_double kernel: bit-equal at [128, 128], its
                [2048, 2048] one-block launch refused); every kernel's
                launch plan (kernels/plans.py) equals the library's own
                query at the shapes of the registry and the earlier phases;
                the registry's programs (fl_round_sharded on a one-rank
                1x1 mesh) run clean with launches equal to their kernel
                records, and torch.cuda.set_sync_debug_mode agrees with the
                host-sync rule on each; then
                make_fl_train_loop on full-size Llama-3.2-1B (8 clients x
                2 x 512, 2 steps) under the recorder: no host sync, no f64,
                no rebuild on a repeat call, every kernel block within the
                card's shared memory, the liveness estimate the
                memory-ceiling rule applies within 10% of the measured
                peak rise, the loop equal to the folded step, the step
                time with and without the recorder, and sample_z's time
                against erfinv's float64 Horner form;
10b. stack      the train burst's stacked (w+, w-) forward
                (make_fl_train_loop's stack_forwards under torch.func.vmap)
                against its two forwards in sequence: rows 3 and 8 folded
                under vmap, one launch each bit-equal to a launch per
                member, with the ms of each way; then TINY at d_model 256
                (the auto rule stacks) at S 512, Llama-3.2-1B at full
                width (8 clients x 2 x 512, 2 steps) and Jamba-1.5-Large
                at full width cut to 2 layers (attention, Mamba: the flat
                route's copies of the 4-layer cut do not fit), each with
                the first pair's per-example losses within 1e-5, the
                scalars within the loss gaps over 2 eps, the parameters
                within lr |dg| max|z|, row-3 launches a step (the attention
                layers, twice that in sequence), ms a step and the peak
                memory each way; then tools/kill_recover_torch.py's drill
                on the card, plain and with --sample-frac 0.5 --quantize
                int8 side by side (SIGKILLed in round 2, resumed bit-equal).

Phases 4 to 10b (4b-4g, 9b-9d too) each count every kernel's launches
from zero, and each count must be the count its run implies.

Then the kernels line, the card line, and ``{"ok": true, "device": ...}``
last.  Any failed check raises and the script exits non-zero; without a
CUDA device, or outside a checkout, it exits non-zero before printing a
result.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the slice: examples/quickstart.py's calls plus MEERKAT-VP, at full size
SEED = 0
# every phase but autotune reads an empty tiling table (the kernels'
# default tilings, as in the parent commit); autotune writes and reads its
# own (both under build/, git-ignored, and removed at the end)
EMPTY_TABLE = ROOT / "build" / f"autotune_empty_{os.getpid()}"
TUNED_TABLE = ROOT / "build" / f"autotune_tuned_{os.getpid()}"
AUTOTUNE_REPS = 3
AUTOTUNE_TURNS = 2
N_CLIENTS = 8
CLIENT_BATCH = 16
SEQ_LEN = 512
DENSITY = 1e-3
T_CALI = 4
ROUNDS = 3
EVAL_EXAMPLES = 32
PRETRAIN_BATCHES, PRETRAIN_BATCH = 2, 4
# the fleet: 16 Dirichlet clients, a cohort of half each round, the int8
# uplink (stochastic, exact replay), faults; FLEET_ROUNDS rounds with a
# checkpoint after FLEET_ROUNDS // 2 and a resumed twin for the rest
FLEET_CLIENTS = 16
FLEET_FRAC = 0.5
FLEET_T = 2
FLEET_ROUNDS = 4
FLEET_QUANTIZE = "int8"
FLEET_DROP, FLEET_LATE, FLEET_STALENESS = 0.2, 0.2, 2
# chosen once (the first seed that qualifies): with the sampler's cohorts
# it gives in-cohort drops and a straggler of round 1 still in flight at
# the round-2 checkpoint, landing in round 3, so the restored queue is used
FLEET_FAULT_SEED = 0
# the sharded round (phase mesh): the slice's problem on a one-rank 1x1
# mesh (one NCCL rank on the card); VP calibration of MESH_T_CALI steps,
# then MESH_ROUNDS rounds unsharded and under FSDP, one under "replicate";
# make_fl_train_loop of MESH_LOOP_STEPS steps at 8 x MESH_LOOP_BATCH x
# SEQ_LEN held to tools/fl_mesh_parity.py's tolerance; MESH_ZO_STEPS timed
# client steps for the roofline line
MESH_SPEC, MESH_T_CALI, MESH_ROUNDS = "1x1", 2, 2
MESH_LOOP_STEPS, MESH_LOOP_BATCH = 2, 2
MESH_LOOP_PARAM_ATOL, MESH_LOOP_G_ATOL = 2e-5, 2e-4
MESH_ZO_STEPS = 3
# phase tp: rounds of the tp rule against the unsharded ones, and the MoE
# layer's batch (x SEQ_LEN tokens)
TP_ROUNDS, TP_MOE_BATCH = 2, 4
# the dryrun line's single-mesh records (bf16, as the JAX dry run)
DRYRUN_SINGLE = (("qwen3-4b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k"))
# LoRA-FedZO on Llama-3.2-1B (phase lora): rank 4, alpha 16 on q and v;
# T=2 at Table 1's LoRA rate, two clients early-stopped at random
LORA_RANK, LORA_T, LORA_ROUNDS, LORA_LR = 4, 2, 2, 2e-2
LORA_EARLY_STOP, LORA_STOP_SEED = 2, 7
# MEERKAT on Qwen3-4B at full width, 8 of 36 layers (phase slice_qwen3):
# the six flat f32 vectors of the ZO route stay within half of the card
QWEN3_LAYERS, QWEN3_ROUNDS = 8, 2
# the other options (phase options): ChatGLM3-6B (partial RoPE, QKV bias,
# G 16) and Phi-3.5-MoE (LayerNorm, 16 experts top-2), full width, a few
# layers; the logits and LM loss of B x S on the kernel, online and dense
# routes, the dense route chunked: the losses within OPTIONS_ROUTE_REL of
# the kernel route's, the logits' max abs gap within OPTIONS_LOGIT_REL of
# the kernel route's max |logit| (the routes' gap measured 6.8e-6 on an
# H100 at these shapes: the bound is three times it)
CHATGLM_LAYERS, PHI_LAYERS = 2, 1
OPTIONS_B, OPTIONS_S, OPTIONS_Q_BLOCK = 2, 1024, 256
OPTIONS_ROUTE_REL = 1e-4
OPTIONS_LOGIT_REL = 2e-5
# ChatGLM3 behind the engine: prompts of 1024 and 300, 16 greedy tokens,
# on the flash-decode kernel at G 16 (its largest group)
CHATGLM_PROMPTS, CHATGLM_NEW = (1024, 300), 16
# the first-order baseline: Adam steps and one FedAvg round, batch 4 x 512
FO_BATCH = 4
FO_ADAM_STEPS = 2
FO_LOCAL_STEPS = 1
FO_LR = 1e-4
# serving: Llama-3.2-1B behind the continuous-batching engine, greedy
SERVE_SLOTS, SERVE_S_MAX, SERVE_BUCKET = 8, 2048, 16
SERVE_REQUESTS, SERVE_PROMPT_LENS, SERVE_NEW = 24, (32, 1536), (16, 96)
# Gemma-2-2b, 2 periods at full width: one prompt past the 4096 window
GEMMA_PROMPTS, GEMMA_NEW, GEMMA_S_MAX = (4200, 100), 32, 4352
# ... and under autograd (phase grad_gemma): the mask and one gradient of a
# 1 x 4352-token batch, past the window, so the local layers mask
GEMMA_GRAD_TOKENS = 4352
# an engine token must be within this share of max |logit| of the largest
# logit of the request replayed alone; the kernel and ref decode routes'
# logits within this share of the largest
SERVE_TIE_REL = 1e-5
SERVE_ROUTE_REL = 1e-4
# kernel-route vs dense-route gradient of the whole model: per leaf, max |d|
# over max |g|, within the JAX package's own whole-model rtol
# (tests/test_attn_vjp.py); and the share of mask coordinates both pick
GRAD_REL_BOUND = 2e-3
MASK_OVERLAP_MIN = 0.999
# backward kernels against their plain versions: both compute in f32 from
# the same (widened) operands, summing up to S*G terms in another order
# (the kernels' products as 3xTF32 on the tensor cores, f32-accurate)
BWD_REL_TOL = 1e-4
# the backward variant grid's (G, head_dim): Llama's and Jamba's layouts,
# a G that does not divide the 64-row tile, and Gemma-2's head_dim 256
BWD_LAYOUTS = ((1, 64), (4, 64), (1, 128), (4, 128), (6, 64), (1, 256),
               (2, 256))
# decode kernel against its plain version, of the largest entry: f32 splits
# merged in another order than one softmax; bf16 one rounding of the result
DECODE_REL_TOL = {"f32": 1e-5, "bf16": 8e-3}
DECODE_LAYOUTS = ((4, 64), (6, 128), (2, 256), (1, 64))

# the hybrid slice: Jamba-1.5-Large at full width, 4 layers, no experts
JAMBA_CLIENT_BATCH = 4
JAMBA_T_CALI = 2
JAMBA_ROUNDS = 2
JAMBA_EVAL = 16
JAMBA_PRETRAIN_BATCHES, JAMBA_PRETRAIN_BATCH = 2, 4
JAMBA_MOE_BATCH = 4
# the MoE FFN against moe_loop_ref, of the largest entry: the same f32
# products, summed by GEMMs of other shapes (the experts' [C, D] buffers
# against each expert's gathered rows); capacity 0.5 makes C = 128 against
# ~256 pairs offered to each expert, so the loop must drop pairs
MOE_LOOP_REL = 1e-5
MOE_TIGHT_CAPACITY = 0.5
# the selective-scan kernel against its plain version, y and h_last each
# of its largest entry: f32 sums of the same terms over up to S steps in
# which the state decays little (dt ~ 0.01), fused there and not here
MAMBA_SCAN_REL = 1e-5
MAMBA_VARIANTS = ((3, 37, 200, 16), (2, 300, 256, 8), (1, 1, 128, 16),
                  (4, 512, 16384, 16))  # (B, S, E, N); the last: the slice's
# the kernel route's logits against the scan route's, of max |logit|: the
# serial scan against the parallel prefix, through 3 Mamba layers
MAMBA_ROUTE_REL = 1e-4
# hybrid serving (phase serve_jamba): Jamba-1.5-Large at full width, one
# period of (attention, dense) and (Mamba, MoE); six greedy requests
# through 4 slots, budgets that differ so that waves are admitted
# mid-decode; the decode routes over the first JAMBA_ROUTE_STEPS tokens
JAMBA_SERVE_PATTERN = (("attn", "dense"), ("mamba", "moe"))
JAMBA_SERVE_PROMPTS = (1, 77, 300, 1024, 1500, 640)
JAMBA_SERVE_NEW = (16, 8, 16, 12, 16, 16)
JAMBA_SERVE_SLOTS, JAMBA_SERVE_S_MAX, JAMBA_ROUTE_STEPS = 4, 2048, 4
# the first wave's prefill Mamba state and conv buffer, kernel route
# against scan route, of the leaf's largest entry
MAMBA_STATE_REL = 1e-5
# the other families (phase families): xLSTM-350m rounds (no VP
# calibration) and serving; Whisper-small and Pixtral-12b (2 of 40 layers)
# serving; for each, prefill of FAMILY_FWD_S - 1 tokens and one decode step
# against the training forward's last two logits, of its max |logit|
FAMILY_ROUNDS = 2
PIXTRAL_LAYERS = 2
FAMILY_SLOTS, FAMILY_NEW, FAMILY_FWD_S = 4, 16, 300
FAMILY_FWD_REL = 1e-4
XLSTM_PROMPTS, XLSTM_S_MAX = (1, 700, 233, 467, 90, 600), 720
WHISPER_PROMPTS, WHISPER_S_MAX = (1, 300, 64, 400), 448
PIXTRAL_PROMPTS, PIXTRAL_S_MAX = (1, 200, 500, 64), 784

# the analyzer's fixture kernel: [128, 128] f32 in one block fits a block
# (131,072 B of shared memory); [2048, 2048] in one block asks 33,554,432 B
# and the card must refuse it.  Blocks of 32, 128, then 50 rows at
# [128, 128]: the launcher's granted shared bytes rise, then are reused
FIXTURE_GOOD, FIXTURE_BAD = (128, 128), (2048, 2048)
FIXTURE_BLOCK_ROWS = (32, 128, 50)
# host-bound kernels against their library call: turns of (kernel,
# library, library, kernel), the median over TURNS
TURNS = 7
# the analysis phase's full-width run: make_fl_train_loop on Llama-3.2-1B,
# 8 clients x batch 2 x SEQ_LEN, 2 steps; the liveness estimate of the
# recorded call within AN_LIVENESS_REL of torch.cuda.max_memory_allocated's
# rise over it
AN_CLIENTS, AN_BATCH, AN_STEPS = 8, 2, 2
AN_LIVENESS_REL = 0.10
# sample_z against erfinv's float64 Horner form: both round each Horner step
# once but for rare double roundings, so they differ by an ulp or two where
# they differ; 1e-5 is some 20 ulp of the largest normals (|z| < 6)
Z_F64_ABS = 1e-5
# phase stack: the train burst's stacked (w+, w-) forward against its two
# forwards in sequence.  The folded launches at Llama's flash shape (q [2 x
# 16, 512, 32, 64]) and Jamba's scan shape (dt, x [2 x 4, 512, 16384], an A
# a member); then TINY at d_model 256 and vocab 256 (the analyzer
# registry's, under STACK_FORWARDS_MAX_PARAMS: auto stacks) at S 512 (the
# flash route), Llama-3.2-1B at full width as phase analysis runs its
# burst, and Jamba-1.5-Large at full width on the flat route, which holds
# some five f32 copies of the parameters (the tree, w, z, the pair): the
# slice_jamba cut's 4.9 B parameters need 98 GB so, so it is cut to its
# first STACK_JAMBA_LAYERS layers (attention, Mamba).  Per-example losses
# of the burst's first pair within STACK_LOSS_REL of the sequential ones;
# the scalars within the loss gaps over 2 eps; the parameters within
# lr |dg| max|z| a step
STACK_TINY_CLIENTS, STACK_TINY_BATCH, STACK_TINY_STEPS = 4, 4, 8
STACK_TINY_S = 512
STACK_JAMBA_LAYERS, STACK_JAMBA_CLIENTS = 2, 4
STACK_LOSS_REL = 1e-5
STACK_EPS, STACK_LR = 1e-3, 1e-2
# the drill (tools/kill_recover_torch.py) on the card: TINY, 4 rounds, the
# kill in round 2, plain and with client sampling and the int8 uplink
STACK_DRILLS = ((), ("--sample-frac", "0.5", "--quantize", "int8"))

# the H100 SXM data sheet's peaks are repro_torch.launch.roofline.HW
# (peak(): HBM3's rate, the f32 rate outside the tensor cores, where the
# kernels compute in f32, and the dense TF32 rate of the tensor cores, where
# the flash kernels run each f32 product as three TF32 products, 3xTF32);
# the f32 rate is 132 SMs x 128 lanes x 2 (FMA) at the 1.98 GHz boost clock
SM_CLOCK_HZ = 1.98e9
# exponentials: 16 a clock per SM on the special-function units (NVIDIA's
# arithmetic-instruction throughput table, compute capability 9.0), at the
# clock of the f32 rate
EXP_PER_S = 16 * 132 * SM_CLOCK_HZ

# phase examples: each example's CI smoke flags (the largest model any
# example defines for train_e2e), and the kernel rows its path must launch
EXAMPLE_ARGV = (("quickstart", ("--rounds", "8")),
                ("train_e2e", ("--large", "--rounds", "2", "--T", "2")),
                ("vpcs_demo", ("--steps", "60")),
                ("serve_batch", ()),
                ("mesh_round", ("--mesh", "1x1", "--rounds", "2", "--T",
                                "2")))
ZO_ROWS = ("zo_dual_perturb_flat", "zo_fused_update_flat")
EXAMPLE_ROWS = {"quickstart": ZO_ROWS,
                "train_e2e": ZO_ROWS + ("gradip_flat",),
                "vpcs_demo": ZO_ROWS + ("gradip_flat",),
                "serve_batch": ("flash_decode",),
                "mesh_round": ZO_ROWS}
# the hlo_tools line: JAX's docstring example at production width
HLO_TOOLS_ARGV = ("--arch", "qwen2-7b", "--shape", "decode_32k", "--depth",
                  "1", "--top", "5")
KERNEL_SOURCES = {
    "zo_dual_perturb_flat": ("src/repro_torch/kernels/csrc/zo_update.cu",
                             "src/repro/kernels/zo_update.py:40"),
    "zo_fused_update_flat": ("src/repro_torch/kernels/csrc/zo_update.cu",
                             "src/repro/kernels/zo_update.py:90"),
    "gradip_flat": ("src/repro_torch/kernels/csrc/gradip.cu",
                    "src/repro/kernels/gradip_reduce.py:33"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attention.py:159"),
    "flash_attention_bwd_dq": ("src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
                               "src/repro/kernels/flash_attention.py:285"),
    "flash_attention_bwd_dkv": (
        "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
        "src/repro/kernels/flash_attention.py:310"),
    "flash_decode": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                     "src/repro/kernels/decode_attention.py:64"),
    "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:63"),
    "fixture_double": ("src/repro_torch/kernels/csrc/fixture_double.cu",
                       "src/repro/analysis/fixtures.py:182"),
}
# fields a kernel row carries into the kernels line beside the required
# ones, all measured in the run but bounds: the flash backward's pair timed
# in turns with SDPA, its Gemma-2 (head_dim 256) instance, rows 3, 5-6 and 7
# at Qwen3-4B's and ChatGLM3-6B's shapes (check_new_shapes), rows 3, 7 and
# 8 at the serving shapes of phases serve_jamba and families
# (check_serving_shapes: "jamba_serve", "whisper"), and rows 1, 2 and 4 at
# the flat and GradIP sizes of phases lora and slice_qwen3
# (check_elementwise, check_gradip)
KERNEL_LINE_EXTRAS = ("pair_ms_in_turns", "gemma", "qwen3", "chatglm3",
                      "lora", "jamba_serve", "whisper", "tilings")
# the forward's (G, head_dim) layouts: Llama's and Gemma's, Jamba's G 8 at
# 128, and G 64 (one query a block) at 64 and at 256
FLASH_LAYOUTS = ((1, 64), (4, 64), (1, 128), (4, 128), (2, 256), (8, 128),
                 (64, 64), (64, 256))
# the variant grid of the flash kernels: (S, window, softcap, lengths)
FLASH_VARIANTS = ((128, 0, 0.0, None),       # causal
                  (200, 0, 0.0, (200, 77)),  # ragged S, lengths
                  (256, 48, 0.0, None),      # window
                  (130, 32, 30.0, (130, 1)))  # window, softcap, length 1


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, iters: int, host: bool = False):
    """Mean ms per call over ``iters`` calls after two warm-up calls (CUDA
    events around the whole run).  With ``host``, (that, enqueue ms): the
    host clock per call over the same loop, read before the closing
    synchronize; where the two are close, the host sets the time."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    h1 = time.perf_counter()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / iters
    return (ms, (h1 - h0) * 1e3 / iters) if host else ms


def kernel_times(fn, iters: int) -> dict:
    """A kernel row's ``ms`` and ``enqueue_ms`` (:func:`timed`)."""
    ms, enqueue_ms = timed(fn, iters, host=True)
    return dict(ms=ms, enqueue_ms=enqueue_ms)


def timed_turns(kernel, library, iters: int, turns: int = TURNS) -> dict:
    """A kernel and the library call that computes the same function, timed
    in turns (kernel, library, library, kernel): a turn's reading of each is
    the mean of its two, and each number is the median over ``turns``
    turns.  Host-bound calls move by up to 2x between calls; turns put both
    under the same conditions."""
    k, ke, lib, libe = [], [], [], []
    for _ in range(turns):
        a, b, c, d = (timed(f, iters, host=True)
                      for f in (kernel, library, library, kernel))
        k.append((a[0] + d[0]) / 2)
        ke.append((a[1] + d[1]) / 2)
        lib.append((b[0] + c[0]) / 2)
        libe.append((b[1] + c[1]) / 2)
    med = statistics.median
    return dict(ms=med(k), enqueue_ms=med(ke), library_ms=med(lib),
                library_enqueue_ms=med(libe), turns=turns, ms_turns=k,
                library_ms_turns=lib)


def queued_ms(torch, launch, calls: int = 20, reps: int = 10) -> float:
    """Device ms per launch with no host gap between launches:
    ``launch(stream)`` (one kernel launch on the raw stream handle) queued
    ``calls`` times between CUDA events behind a ~1 ms spin kernel, so the
    card runs them back to back once the spin ends; the median of ``reps``.
    (Not a CUDA graph: gradip_flat refuses capture.)"""
    stream = torch.cuda.current_stream().cuda_stream
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # cycles: the launches queue meanwhile
        t0.record()
        for _ in range(calls):
            launch(stream)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return statistics.median(times)


def host_us(fn, iters: int = 200, reps: int = 5) -> float:
    """Median over ``reps`` loops of the host clock per call of ``fn`` (us),
    with no synchronize inside a loop and one after it."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        h0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per.append((time.perf_counter() - h0) * 1e6 / iters)
        torch.cuda.synchronize()
    return statistics.median(per)


def peak(key: str) -> float:
    """One of the card's data-sheet peaks (``launch/roofline.HW``)."""
    from repro_torch.launch.roofline import HW
    return HW[key]


def bound(n_bytes: float, n_ops: float, flop_per_s: float = None):
    mem_ms = n_bytes / peak("hbm_bw") * 1e3
    op_ms = n_ops / (flop_per_s or peak("peak_flops_f32")) * 1e3
    return max(mem_ms, op_ms), ("bytes" if mem_ms >= op_ms else "operations")


# ----------------------------------------------------------------- kernels --
def check_elementwise(torch, ops, ref, dev, n_slice: int, extra: dict):
    """dual_perturb and fused_update: bit-equal to the plain version (both
    round the f32 product, then add in w's dtype), on a grid of sizes, at
    the slice's flat vector and at the other phases' (``extra``: {config:
    n_pad}, each a row of the config's name beside the slice's)."""
    from repro_torch.kernels import plans
    gen = torch.Generator(device=dev).manual_seed(1)
    ch = plans.zo_update_chunk(True)  # fused_update's block: 16,384
    for n in (1, 1023, ch - 1, ch, ch + 1, 1_000_003, 4096 * 1024):
        for dtype in (torch.float32, torch.bfloat16):
            w = torch.randn(n, generator=gen, device=dev).to(dtype)
            z = torch.randn(n, generator=gen, device=dev)
            m = (torch.rand(n, generator=gen, device=dev) < 0.3).float()
            for mm in (None, m):
                p, q = ops.zo_dual_perturb_flat(w, z, mm, 1e-3)
                rp, rq = ref.dual_perturb_ref(w, z, mm, 1e-3)
                s = torch.tensor(-7.31e-4, device=dev)
                u = ops.zo_fused_update_flat(w, z, mm, s)
                ru = ref.fused_update_ref(w, z, mm, s)
                if not (torch.equal(p, rp) and torch.equal(q, rq)
                        and torch.equal(u, ru)):
                    fail(f"elementwise kernels differ from plain at n={n} "
                         f"{dtype} masked={mm is not None}")
    emit("kernels.elementwise_variants", ok=True,
         checked=f"n in {{1, 1023, {ch - 1}, {ch}, {ch + 1}, 1000003, "
                 f"4194304}} x {{f32, bf16}} x {{m, no m}}")

    # the slice's shape: the flat Llama-3.2-1B vector, f32, pre-masked z
    w = torch.randn(n_slice, generator=gen, device=dev)
    z = torch.randn(n_slice, generator=gen, device=dev)
    out = {}
    p, q = ops.zo_dual_perturb_flat(w, z, None, 1e-3)
    rp, rq = ref.dual_perturb_ref(w, z, None, 1e-3)
    err = max(float((p - rp).abs().max()), float((q - rq).abs().max()))
    del p, q, rp, rq
    if err != 0.0:
        fail(f"dual_perturb differs from plain at the slice shape: {err}")
    b_ms, b_by = bound(16.0 * n_slice, 3.0 * n_slice)
    out["zo_dual_perturb_flat"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **kernel_times(lambda: ops.zo_dual_perturb_flat(w, z, None, 1e-3),
                       10),
        plain_ms=timed(lambda: ref.dual_perturb_ref(w, z, None, 1e-3), 10),
        shape=f"[{n_slice}] f32, pre-masked z")
    s = torch.tensor(-1e-3 * 0.731, device=dev)
    u = ops.zo_fused_update_flat(w, z, None, s)
    err = float((u - ref.fused_update_ref(w, z, None, s)).abs().max())
    del u
    if err != 0.0:
        fail(f"fused_update differs from plain at the slice shape: {err}")
    b_ms, b_by = bound(12.0 * n_slice, 2.0 * n_slice)
    s_host = float(s)
    # in turns with torch.add(w, z, alpha=s), the same bytes (median of 7)
    out["zo_fused_update_flat"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timed_turns(lambda: ops.zo_fused_update_flat(w, z, None, s),
                      lambda: torch.add(w, z, alpha=s_host), 10),
        plain_ms=timed(lambda: ref.fused_update_ref(w, z, None, s), 10),
        shape=f"[{n_slice}] f32, pre-masked z")
    emit("kernels.fused_update_turns", ok=True,
         ms=out["zo_fused_update_flat"]["ms"],
         torch_add_ms=out["zo_fused_update_flat"]["library_ms"],
         at_or_under_torch_add=out["zo_fused_update_flat"]["ms"]
         <= out["zo_fused_update_flat"]["library_ms"],
         ms_turns=out["zo_fused_update_flat"]["ms_turns"],
         torch_add_ms_turns=out["zo_fused_update_flat"]["library_ms_turns"],
         bytes_rate_tb_s=12.0 * n_slice / out["zo_fused_update_flat"]["ms"]
         / 1e9)
    del w, z
    for tag, n in extra.items():
        for name, row in flat_rows(torch, ops, ref, dev, gen, n).items():
            out[name][tag] = row
    return out


def flat_rows(torch, ops, ref, dev, gen, n: int) -> dict:
    """dual_perturb and fused_update at one more flat size (f32, pre-masked
    z, as the phases run them): each bit-equal to its plain version, timed
    beside it, its library call (fused_update: torch.add) and its bound."""
    w = torch.randn(n, generator=gen, device=dev)
    z = torch.randn(n, generator=gen, device=dev)
    shape = f"[{n}] f32, pre-masked z"
    p, q = ops.zo_dual_perturb_flat(w, z, None, 1e-3)
    rp, rq = ref.dual_perturb_ref(w, z, None, 1e-3)
    err = max(float((p - rp).abs().max()), float((q - rq).abs().max()))
    del p, q, rp, rq
    if err != 0.0:
        fail(f"dual_perturb differs from plain at n={n}: {err}")
    b_ms, b_by = bound(16.0 * n, 3.0 * n)
    dual = dict(
        shape=shape, max_abs_err=err,
        ms=timed(lambda: ops.zo_dual_perturb_flat(w, z, None, 1e-3), 10),
        plain_ms=timed(lambda: ref.dual_perturb_ref(w, z, None, 1e-3), 3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    s = torch.tensor(-1e-3 * 0.731, device=dev)
    u = ops.zo_fused_update_flat(w, z, None, s)
    err = float((u - ref.fused_update_ref(w, z, None, s)).abs().max())
    del u
    if err != 0.0:
        fail(f"fused_update differs from plain at n={n}: {err}")
    b_ms, b_by = bound(12.0 * n, 2.0 * n)
    s_host = float(s)
    fused = dict(
        shape=shape, max_abs_err=err,
        ms=timed(lambda: ops.zo_fused_update_flat(w, z, None, s), 10),
        plain_ms=timed(lambda: ref.fused_update_ref(w, z, None, s), 3),
        library_ms=timed(lambda: torch.add(w, z, alpha=s_host), 10),
        library="torch.add(w, z, alpha=s)", bound_ms=b_ms, bound_by=b_by)
    return {"zo_dual_perturb_flat": dual, "zo_fused_update_flat": fused}


def gradip_two_streams(torch, ops, gp, z, g, calls: int = 4):
    """gradip_flat from two side streams at once, ``calls`` each,
    interleaved: the results (each stream has its own scratch and ticket)."""
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream() for _ in range(2)]
    for s in streams:
        s.wait_stream(main)
    outs = []
    for _ in range(calls):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(ops.gradip_flat(gp, z, g))
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize()
    return outs


def gradip_capture_refusals(torch, ops, gp, z) -> list:
    """gradip_flat under CUDA graph capture, on a side stream with no
    scratch yet (the wrapper refuses) and then with one (the launcher
    refuses): each refusal's message, or None where the call was captured
    or launched.  A graph would replay the capture stream's scratch and
    ticket on any stream."""
    side = torch.cuda.Stream()
    refusals = []
    for warm in (False, True):
        side.wait_stream(torch.cuda.current_stream())
        if warm:
            with torch.cuda.stream(side):
                ops.gradip_flat(gp, z, 1.7)
        before = ops.gradip_flat.launches
        try:
            with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
                ops.gradip_flat(gp, z, 1.7)
            refusals.append(None)
        except RuntimeError as e:
            refusals.append(str(e) if ops.gradip_flat.launches == before
                            else None)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return refusals


def check_gradip(torch, ops, ref, dev, n_slice: int, extra: dict):
    """gradip_flat against its plain version at n in {1, 777, 1e7, the
    other phases' (``extra``: {config: n}), the slice's}; bit-equal over 3
    repeats and from two streams at once; one launch a call; refused under
    CUDA graph capture.  At the slice's n (where MEERKAT-VP runs it) timed
    in turns against torch.dot, at each ``extra`` n timed beside its plain
    version and torch.dot (a row of the config's name), and device time
    alone at n = 1e7."""
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    tags = {n: tag for tag, n in extra.items()}
    rows = {}
    for n in (1, 777, 10_000_000, *extra.values(), n_slice):
        gp = torch.randn(n, generator=gen, device=dev)
        z = torch.randn(n, generator=gen, device=dev)
        before = ops.gradip_flat.launches
        got = ops.gradip_flat(gp, z, 1.7)
        if got.shape != () or ops.gradip_flat.launches != before + 1:
            fail(f"gradip is not one 0-d result of one launch at n={n}")
        want = ref.gradip_reduce_ref(gp, z, 1.7)
        err = abs(float(got) - float(want))
        # f32 sums in two orders: within 1e-5 of the sum of |terms|
        if err > 1e-5 * 1.7 * float((gp * z).abs().sum()):
            fail(f"gradip differs from plain at n={n}: {err}")
        if not all(torch.equal(ops.gradip_flat(gp, z, 1.7), got)
                   for _ in range(3)):
            fail(f"gradip is not bit-equal over repeats at n={n}")
        if not all(torch.equal(o, got)
                   for o in gradip_two_streams(torch, ops, gp, z, 1.7)):
            fail(f"gradip is not bit-equal across two streams at n={n}")
        if n == 10_000_000:
            big_ms = timed(lambda: ops.gradip_flat(gp, z, 1.7), 20)
            big_bound, _ = bound(8.0 * n + 4, 2.0 * n)
        if n in tags and n != n_slice:
            b_ms, b_by = bound(8.0 * n + 4, 2.0 * n)
            rows[tags[n]] = dict(
                shape=f"[{n}] f32", max_abs_err=err,
                ms=timed(lambda: ops.gradip_flat(gp, z, 1.7), 50),
                plain_ms=timed(lambda: ref.gradip_reduce_ref(gp, z, 1.7), 50),
                library_ms=timed(lambda: torch.dot(gp, z), 50),
                library="torch.dot", bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = bound(8.0 * n_slice + 4, 2.0 * n_slice)
    out["gradip_flat"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timed_turns(lambda: ops.gradip_flat(gp, z, 1.7),
                      lambda: torch.dot(gp, z), 50),
        plain_ms=timed(lambda: ref.gradip_reduce_ref(gp, z, 1.7), 50),
        ms_1e7=big_ms, bound_ms_1e7=big_bound,
        shape=f"[{n_slice}] f32", **rows)
    refusals = gradip_capture_refusals(torch, ops, gp, z)
    if None in refusals:
        fail(f"gradip was not refused under CUDA graph capture: {refusals}")
    if not torch.equal(ops.gradip_flat(gp, z, 1.7), got):
        fail("gradip differs after the refused captures")
    emit("kernels.gradip_variants", ok=True,
         checked=f"n in {{1, 777, 1e7, {', '.join(map(str, extra.values()))}"
                 f", slice n}}; one launch, 0-d; bit-equal "
                 "over 3 repeats and from 2 streams x 4 calls; refused "
                 "under graph capture", refusals=refusals)
    out["gradip_flat"]["host_us"] = host_split_gradip(torch, ops, gp, z)
    return out


def host_split_gradip(torch, ops, gp, z):
    """Host us per call of gradip_flat and of its pieces, at the slice's n:
    where the host time of a call goes."""
    from repro_torch.kernels import build
    lib = build.load()
    idx = gp.get_device()
    st = ops._stream(gp)
    scratch_ptr, like = ops._gradip_scratch[(idx, st)]
    out = torch.empty((), dtype=torch.float32, device=gp.device)
    args = (gp.data_ptr(), z.data_ptr(), 1.7, scratch_ptr, out.data_ptr(),
            gp.numel())
    return dict(
        device_us_queued=1e3 * queued_ms(
            torch, lambda s: lib.gradip_reduce(*args, s)),
        wrapper=host_us(lambda: ops.gradip_flat(gp, z, 1.7)),
        wrapper_unrecorded=host_us(
            lambda: ops.gradip_flat.__wrapped__(gp, z, 1.7)),
        on_cpu=host_us(lambda: ops._on_cpu(gp, z)),
        stream_raw=host_us(
            lambda: torch._C._cuda_getCurrentRawStream(idx)),
        stream_object=host_us(
            lambda: torch.cuda.current_stream(gp.device).cuda_stream),
        empty_like_0d=host_us(lambda: torch.empty_like(like)),
        empty_0d_device_arg=host_us(lambda: torch.empty(
            (), dtype=torch.float32, device=gp.device)),
        ctypes_launch=host_us(lambda: lib.gradip_reduce(*args, st)),
        library=host_us(lambda: torch.dot(gp, z)))


def _attn(torch, dev, gen, B, S, KV, G, dh, dtype):
    q = torch.randn(B, S, KV * G, dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, S, KV, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, KV, dh, generator=gen, device=dev).to(dtype)
    return q, k, v


def check_flash(torch, ops, ref, dev, cfg, batch: int):
    """The forward kernel against its plain version over the variant grid
    (bit-equal over two calls), then at the slice's shape: timed in turns
    with SDPA's f32 forward against its 3xTF32 bound, with its record of
    its blocks (heaviest query tiles first) and the one-pass TF32 control
    (``ops.flash_attention_fwd_probe``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import plans
    gen = torch.Generator(device=dev).manual_seed(3)
    check_tiling_variants(torch, ops, ref, dev)
    n_var = 0
    for dtype in (torch.float32, torch.bfloat16):
        for G, dh in FLASH_LAYOUTS:
            for S, window, softcap, lens in FLASH_VARIANTS:
                q, k, v = _attn(torch, dev, gen, 2, S, 2, G, dh, dtype)
                L = torch.tensor(lens or (S, S), device=dev)
                o, lse = ops.flash_attention(q, k, v, L, window=window,
                                             softcap=softcap,
                                             return_lse=True)
                ro, rlse = ref.flash_attention_ref(
                    q, k, v, L, window=window, softcap=softcap, causal=True)
                # f32: two summation orders; bf16: one bf16 rounding of the
                # same f32 result (a bf16 ulp at |O| < 4)
                atol = 1e-4 if dtype == torch.float32 else 1.6e-2
                e_o = float((o.float() - ro.float()).abs().max())
                e_l = float((lse - rlse).abs().max())
                if e_o > atol or e_l > 1e-4:
                    fail(f"flash differs from plain: {dtype} G={G} dh={dh} "
                         f"S={S} window={window} softcap={softcap} "
                         f"lengths={lens}: O {e_o}, lse {e_l}")
                o2, lse2 = ops.flash_attention(q, k, v, L, window=window,
                                               softcap=softcap,
                                               return_lse=True)
                if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                    fail(f"flash forward is not bit-equal over two calls: "
                         f"{dtype} G={G} dh={dh} S={S}")
                n_var += 1
    emit("kernels.flash_variants", ok=True, checked=n_var,
         repeat_bit_equal=True,
         grid="{f32,bf16} x (G,dh) in {" + ",".join(
             f"({G},{dh})" for G, dh in FLASH_LAYOUTS) + "} x {causal; "
         "ragged S with lengths; window; window+softcap+lengths}")

    # the slice's shape: one attention layer of the ZO loss forward
    B, S = batch, SEQ_LEN
    KV, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    q, k, v = _attn(torch, dev, gen, B, S, KV, G, dh, torch.float32)
    L = torch.full((B,), S, device=dev)
    o, lse = ops.flash_attention(q, k, v, L, return_lse=True)
    ro, rlse = ref.flash_attention_ref(q, k, v, L, window=0, softcap=0.0,
                                       causal=True)
    err = max(float((o - ro).abs().max()), float((lse - rlse).abs().max()))
    if err > 1e-4:
        fail(f"flash differs from plain at the slice shape: {err}")
    blocks = fwd_blocks(torch, ops, (q, k, v, L), 0, 0.0, (o, lse),
                        (ro, rlse))
    if not blocks["heaviest_first"]:
        fail("the flash forward does not launch its heaviest query tiles "
             "first")
    if blocks["one_pass_abs_err"] <= 1e-4:
        fail(f"the forward's one-pass TF32 control is within 1e-4: "
             f"{blocks['one_pass_abs_err']}, so the gate cannot tell the "
             f"split's precision")
    live = int(ref.attention_valid(S, L, window=0, causal=True).sum()) \
        * KV * G                                   # live (query, key) pairs
    n_bytes = 4.0 * (q.numel() + k.numel() + v.numel() + o.numel()
                     + lse.numel() + L.numel())
    flop = 4.0 * dh * live                         # QK^T and PV: 2 FMA each
    # the kernel runs both products as 3xTF32: three times the FLOP on the
    # tensor cores is its bound, the f32 CUDA cores' a side figure
    tf_ms, tf_by = bound(n_bytes, 3 * flop, peak("peak_flops_tf32"))
    f32_ms, f32_by = bound(n_bytes, flop)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    row = timed_turns(lambda: ops.flash_attention(q, k, v, L),
                      lambda: F.scaled_dot_product_attention(
                          qh, kh, vh, is_causal=True, enable_gqa=True), 10)
    shape = f"q [{B},{S},{KV * G},{dh}] f32, causal, G={G}"
    tilings = {"llama": dict(shape=shape, **tiling_rows(
        torch, ops, (q, k, v, L), dict(window=0, softcap=0.0), (ro, rlse),
        dh, G, 10, 1e-4, "the slice shape"))}
    out = {"flash_attention": dict(
        max_abs_err=err, bound_ms=tf_ms, bound_by=tf_by, **row,
        plain_ms=timed(lambda: ref.flash_attention_ref(
            q, k, v, L, window=0, softcap=0.0, causal=True), 5),
        shape=shape, gflop=flop / 1e9, mbytes=n_bytes / 1e6,
        tilings=tilings)}
    emit("kernels.flash_fwd_turns", ok=True, shape=shape, ms=row["ms"],
         sdpa_ms=row["library_ms"],
         at_or_under_sdpa=row["ms"] <= row["library_ms"],
         ms_turns=row["ms_turns"], sdpa_ms_turns=row["library_ms_turns"],
         turns=TURNS)
    emit("kernels.flash_fwd_bounds", ok=True, shape=shape, ms=row["ms"],
         bound_3xtf32_ms=tf_ms, bound_3xtf32_by=tf_by,
         share_of_3xtf32_bound=tf_ms / row["ms"], bound_f32_ms=f32_ms,
         bound_f32_by=f32_by, share_of_f32_bound=f32_ms / row["ms"],
         gflop=flop / 1e9, mbytes=n_bytes / 1e6, tol=1e-4,
         three_pass_abs_err=err, **blocks)
    # the launcher sets the shared-memory attribute only through its
    # high-water mark: at most once for each instantiation (f32 and bf16,
    # head_dim 64, 128, 256, each head_dim's tilings) in all the launches
    # above and check_tiling_variants'
    n_inst = 2 * sum(map(len, plans.FLASH_FWD_TILINGS.values()))
    sets = attribute_sets("flash_attn_fwd_smem_state", 64, 0,
                          *plans.FLASH_FWD_TILINGS[64][0])
    if sets > n_inst:
        fail(f"the flash forward set its shared-memory attribute {sets} "
             f"times")
    emit("kernels.flash_fwd_attribute", ok=True, attribute_sets=sets,
         instantiations=n_inst)
    return out


def fwd_blocks(torch, ops, args, window, softcap, got, want) -> dict:
    """The forward kernel's record of its blocks on ``args`` (q, k, v, L;
    causal, ``window``, ``softcap``) through
    ``ops.flash_attention_fwd_probe`` (outputs bit-equal to the wrapped
    launch's ``got``), held to ``plans.flash_fwd_tiles``: the key
    tiles the blocks walked, max over mean of them and of their SM clocks,
    and whether no block walks more than one launched before it; then the
    one-pass TF32 control's error against the plain version's ``want``."""
    from repro_torch.kernels import plans
    q, k, v, L = args
    B, S, H, dh = q.shape
    KV = k.shape[2]
    res, rec = ops.flash_attention_fwd_probe(q, k, v, L, window=window,
                                             softcap=softcap)
    if not all(torch.equal(a, b) for a, b in zip(res, got)):
        fail("flash forward: the probe launch differs from the wrapped one")
    tiles = rec[:, 0]
    want_tiles = plans.flash_fwd_tiles(B, S, KV, H // KV, dh,
                                       lengths=[int(x) for x in L],
                                       window=window)
    if tiles.tolist() != want_tiles:
        fail("flash forward: the blocks walked other key tiles than "
             "plans.flash_fwd_tiles")
    clocks = rec[:, 1].double()
    (o1, l1), _ = ops.flash_attention_fwd_probe(
        q, k, v, L, one_pass=True, window=window, softcap=softcap)
    one = max(float((o1 - want[0]).abs().max()),
              float((l1 - want[1]).abs().max()))
    return dict(blocks=rec.shape[0], tiles_max=int(tiles.max()),
                tiles_mean=float(tiles.double().mean()),
                tiles_max_over_mean=float(tiles.max() / tiles.double().mean()),
                clocks_max_over_mean=float(clocks.max() / clocks.mean()),
                heaviest_first=bool((tiles[1:] <= tiles[:-1]).all()),
                one_pass_abs_err=one)


def check_flash_prefill(torch, ops, ref, dev, cfg, lengths):
    """The forward kernel at the serve_gemma prefill wave's shape: right
    padded rows of ``lengths`` tokens (padded to the engine's bucket),
    head_dim 256, G 2, softcap, on the local (windowed) and the global
    layers' masks; O and lse against the plain version, and timed against
    the 3xTF32 bound; the kernel's record of its blocks and the one-pass
    TF32 control on each mask."""
    gen = torch.Generator(device=dev).manual_seed(5)
    B = len(lengths)
    S = -(-max(lengths) // SERVE_BUCKET) * SERVE_BUCKET
    KV, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    q, k, v = _attn(torch, dev, gen, B, S, KV, G, dh, torch.float32)
    L = torch.tensor(lengths, device=dev, dtype=torch.int32)
    out = {}
    for name, window in (("local", cfg.sliding_window), ("global", 0)):
        kw = dict(window=window, softcap=cfg.attn_softcap)
        o, lse = ops.flash_attention(q, k, v, L, return_lse=True, **kw)
        ro, rlse = ref.flash_attention_ref(q, k, v, L, causal=True, **kw)
        err = max(float((o - ro).abs().max()),
                  float((lse - rlse).abs().max()))
        if err > 1e-4:
            fail(f"flash differs from plain at the gemma prefill shape "
                 f"({name}): {err}")
        blocks = fwd_blocks(torch, ops, (q, k, v, L), window,
                            cfg.attn_softcap, (o, lse), (ro, rlse))
        tilings = tiling_rows(torch, ops, (q, k, v, L), kw, (ro, rlse), dh,
                              G, 3, 1e-4, f"the gemma prefill ({name})")
        del o, lse, ro, rlse
        live = int(ref.attention_valid(S, L, window=window,
                                       causal=True).sum()) * KV * G
        n_bytes = 4.0 * (2 * q.numel() + k.numel() + v.numel()
                         + B * KV * S * G + B)
        b_ms, b_by = bound(n_bytes, 3 * 4.0 * dh * live,
                           peak("peak_flops_tf32"))
        f32_ms, _ = bound(n_bytes, 4.0 * dh * live)
        ms = timed(lambda: ops.flash_attention(q, k, v, L, **kw), 5)
        out[name] = dict(
            window=window, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
            ms=ms, share_of_3xtf32_bound=b_ms / ms, bound_f32_ms=f32_ms,
            share_of_f32_bound=f32_ms / ms,
            plain_ms=timed(lambda: ref.flash_attention_ref(
                q, k, v, L, causal=True, **kw), 2),
            gflop=4.0 * dh * live / 1e9, **blocks, tilings=tilings)
    emit("kernels.flash_gemma_prefill", ok=True, tol=1e-4,
         shape=f"q [{B},{S},{KV * G},{dh}] f32, lengths {list(lengths)}, "
               f"softcap {cfg.attn_softcap}", **out)
    return out


def check_flash_bwd(torch, ops, ref, dev, cfg, batch: int, gemma):
    """The dQ and dK/dV kernels against their plain versions on the same
    (q, k, v, lengths, lse, delta, dO), bit-equal over two calls, over the
    variant grid, at the first-order shape and at Gemma-2's head_dim-256
    shape (``gemma``: its local and global layers); the pair timed in
    turns with SDPA's f32 backward; the kernels' record of their blocks
    (balance) and the one-pass TF32 control (precision) on the card."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(4)

    def inputs(B, S, KV, G, dh, dtype, lens, window, softcap):
        q, k, v = _attn(torch, dev, gen, B, S, KV, G, dh, dtype)
        do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        L = torch.tensor(lens or (S,) * B, device=dev, dtype=torch.int32)
        o, lse = ref.flash_attention_ref(q, k, v, L, window=window,
                                         softcap=softcap, causal=True)
        return (q, k, v, L, lse, ref.flash_attention_delta(o, do, KV), do)

    def both(args, kw):
        return ((ops.flash_attention_bwd_dq(*args, **kw),
                 *ops.flash_attention_bwd_dkv(*args, **kw)),
                (ref.flash_attn_bwd_dq_ref(*args, **kw),
                 *ref.flash_attn_bwd_dkv_ref(*args, **kw)))

    def rel_err(got, want):
        return [float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                for g, w in zip(got, want)]

    n_var, worst = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for G, dh in BWD_LAYOUTS:
            for S, window, softcap, lens in FLASH_VARIANTS:
                kw = dict(window=window, softcap=softcap, causal=True)
                args = inputs(2, S, 2, G, dh, dtype, lens, window, softcap)
                got, want = both(args, kw)
                errs = rel_err(got, want)
                worst = max(worst, *errs)
                if max(errs) > BWD_REL_TOL:
                    fail(f"flash backward differs from plain: {dtype} G={G} "
                         f"dh={dh} S={S} window={window} softcap={softcap} "
                         f"lengths={lens}: dQ, dK, dV {errs}")
                again = (ops.flash_attention_bwd_dq(*args, **kw),
                         *ops.flash_attention_bwd_dkv(*args, **kw))
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"flash backward is not bit-equal over two calls: "
                         f"{dtype} G={G} dh={dh} S={S}")
                n_var += 1
    emit("kernels.flash_bwd_variants", ok=True, checked=n_var,
         max_rel_err=worst, tol=BWD_REL_TOL, repeat_bit_equal=True,
         grid="{f32,bf16} x (G,dh) in {" + ",".join(
             f"({G},{dh})" for G, dh in BWD_LAYOUTS) + "} x {causal; ragged "
         "S with lengths; window; window+softcap+lengths with a length-1 "
         "row}")

    # the first-order shape: one attention layer of a B x 512 backward
    B, S = batch, SEQ_LEN
    KV, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    kw = dict(window=0, softcap=0.0, causal=True)
    args = inputs(B, S, KV, G, dh, torch.float32, None, 0, 0.0)
    q, k, v, L, lse, delta, do = args
    got, want = both(args, kw)
    errs = rel_err(got, want)
    if max(errs) > BWD_REL_TOL:
        fail(f"flash backward differs from plain at the first-order shape: "
             f"dQ, dK, dV {errs}")
    abs_errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    # the kernels' own record of their blocks, and the one-pass TF32
    # control, which must miss the tolerance the 3xTF32 split keeps
    blocks = bwd_blocks(torch, ops, args, kw, got, (B, KV))
    one_pass = bwd_one_pass(ops, args, kw, want, rel_err)
    bwd_tilings = {"llama": bwd_tiling_rows(
        torch, ops, ref, args, kw, want, dh, G, 10, "the first-order shape")}
    del got, want
    dkv_tiles = blocks["flash_attention_bwd_dkv"]
    if dkv_tiles["tiles_max"] > 1.2 * dkv_tiles["tiles_mean"]:
        fail(f"dK/dV blocks walk unevenly: {dkv_tiles}")
    if not blocks["flash_attention_bwd_dq"]["heaviest_first"]:
        fail("dQ does not launch its heaviest query tiles first")
    if max(one_pass) <= BWD_REL_TOL:
        fail(f"the one-pass TF32 control is within {BWD_REL_TOL}: "
             f"{one_pass}, so the gate cannot tell the split's precision")
    emit("kernels.flash_bwd_one_pass", ok=True, tol=BWD_REL_TOL,
         one_pass_rel_err=one_pass, three_pass_rel_err=errs,
         shape=f"q [{B},{S},{KV * G},{dh}] f32, causal, G={G}")
    # the library yardstick: SDPA's f32 backward (dQ, dK and dV in one
    # call), replayed on one recorded forward
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    o_sdpa = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                            enable_gqa=True)
    pair = timed_turns(
        lambda: (ops.flash_attention_bwd_dq(*args, **kw),
                 ops.flash_attention_bwd_dkv(*args, **kw)),
        lambda: torch.autograd.grad(o_sdpa, (qh, kh, vh), doh,
                                    retain_graph=True), 10)
    del o_sdpa, qh, kh, vh, doh
    emit("kernels.flash_bwd_pair", ok=True,
         shape=f"q [{B},{S},{KV * G},{dh}] f32, causal, G={G}",
         pair_ms=pair["ms"], sdpa_backward_ms=pair["library_ms"],
         pair_at_or_under_sdpa=pair["ms"] <= pair["library_ms"],
         pair_ms_turns=pair["ms_turns"],
         sdpa_backward_ms_turns=pair["library_ms_turns"], turns=TURNS)
    shape = f"q [{B},{S},{KV * G},{dh}] f32, causal, G={G}"
    gem = check_flash_bwd_gemma(torch, ops, ref, dev, gemma, inputs, both,
                                rel_err)
    # the launchers set the shared-memory attribute only through their
    # high-water mark: at most once for each instantiation (dQ and dK/dV,
    # f32 and bf16, head_dim 64, 128, 256, each head_dim's tilings) in all
    # the launches above and check_tiling_variants'
    from repro_torch.kernels import plans
    n_inst = 4 * sum(map(len, plans.FLASH_BWD_TILINGS.values()))
    sets = attribute_sets("flash_attn_bwd_smem_state", 0, 64, 0,
                          *plans.FLASH_BWD_TILINGS[64][0])
    if sets > n_inst:
        fail(f"the flash backward set its shared-memory attribute {sets} "
             f"times")
    emit("kernels.flash_bwd_attribute", ok=True, attribute_sets=sets,
         instantiations=n_inst)
    out, detail = {}, {}
    for name, dkv, n_ops, sl, fn, plain in (
            ("flash_attention_bwd_dq", False, 6.0, slice(0, 1),
             ops.flash_attention_bwd_dq, ref.flash_attn_bwd_dq_ref),
            ("flash_attention_bwd_dkv", True, 8.0, slice(1, 3),
             ops.flash_attention_bwd_dkv, ref.flash_attn_bwd_dkv_ref)):
        flop, n_bytes = bwd_work(ref, q, k, L, dkv, n_ops, 0)
        # per live pair: QK^T and dO V^T (2 FMA x dh each), then dS K for
        # dQ, or P^T dO and dS^T Q for dK/dV; the kernels run each product
        # as 3xTF32, so their bound is three times that on the tensor
        # cores, and the f32 CUDA cores' a side figure
        tf_ms, tf_by = bound(n_bytes, 3 * flop, peak("peak_flops_tf32"))
        f32_ms, f32_by = bound(n_bytes, flop)
        row = kernel_times(lambda: fn(*args, **kw), 10)
        out[name] = dict(
            max_abs_err=max(abs_errs[sl]), max_rel_err=max(errs[sl]),
            bound_ms=tf_ms, bound_by=tf_by, **row,
            plain_ms=timed(lambda: plain(*args, **kw), 5),
            library_ms=pair["library_ms"], pair_ms_in_turns=pair["ms"],
            tilings=bwd_tilings,
            gemma={layer: {k_: r[k_] for k_ in (
                "shape", "max_rel_err", "ms", "bound_ms", "bound_by")}
                for layer, r in gem[name].items()})
        detail[name] = dict(
            shape=shape, ms=row["ms"], bound_3xtf32_ms=tf_ms,
            bound_3xtf32_by=tf_by, share_of_3xtf32_bound=tf_ms / row["ms"],
            bound_f32_ms=f32_ms, bound_f32_by=f32_by,
            share_of_f32_bound=f32_ms / row["ms"], gflop=flop / 1e9,
            mbytes=n_bytes / 1e6, **blocks[name])
    emit("kernels.flash_bwd_bounds", ok=True, **detail)
    emit("kernels.flash_bwd_gemma", ok=True, **gem)
    return out


def bwd_blocks(torch, ops, args, kw, got, lead) -> dict:
    """Both backward kernels' record of their blocks on ``args``
    (``ops.flash_attention_bwd_probe``, outputs bit-equal to the wrapped
    launches' ``got``: dQ, dK, dV): max over mean of the tiles the blocks
    walked and of the SM clocks they took, and whether dQ's blocks walk
    no fewer tiles than the next ones launched (``lead``: the grid's (B,
    KV) before its tile axis)."""
    out = {}
    for name, dkv, sl in (("flash_attention_bwd_dq", False, slice(0, 1)),
                          ("flash_attention_bwd_dkv", True, slice(1, 3))):
        res, rec = ops.flash_attention_bwd_probe(*args, dkv=dkv, **kw)
        res = res if dkv else (res,)
        if not all(torch.equal(a, b) for a, b in zip(res, got[sl])):
            fail(f"{name}: the probe launch differs from the wrapped one")
        tiles, clocks = rec[:, 0].double(), rec[:, 1].double()
        out[name] = dict(
            blocks=rec.shape[0], tiles_max=int(tiles.max()),
            tiles_mean=float(tiles.mean()),
            tiles_max_over_mean=float(tiles.max() / tiles.mean()),
            clocks_max_over_mean=float(clocks.max() / clocks.mean()))
        if not dkv:
            by_launch = rec[:, 0].reshape(*lead, -1)
            out[name]["heaviest_first"] = bool(
                (by_launch[..., 1:] <= by_launch[..., :-1]).all())
    return out


def bwd_one_pass(ops, args, kw, want, rel_err) -> list:
    """dQ, dK, dV of the kernels' one-pass TF32 control
    (``ops.flash_attention_bwd_probe``) against the plain version's
    ``want``: the error the 3xTF32 split removes."""
    dq, _ = ops.flash_attention_bwd_probe(*args, dkv=False, one_pass=True,
                                          **kw)
    (dk, dv), _ = ops.flash_attention_bwd_probe(*args, dkv=True,
                                                one_pass=True, **kw)
    return rel_err((dq, dk, dv), want)


def attribute_sets(state: str, *args) -> int:
    """cudaFuncSetAttribute calls a kernel file's launchers made in this
    process: ``state`` is its ``*_smem_state`` entry point
    (csrc/flash_attn.cu, csrc/flash_attn_bwd.cu, csrc/decode_attn.cu),
    ``args`` one instantiation it takes."""
    import ctypes
    from repro_torch.kernels import build
    out = (ctypes.c_longlong * 2)()
    rc = getattr(build.load(), state)(*args, out)
    if rc:
        fail(f"{state}: CUDA error {rc}")
    return out[1]


def ptxas_spills(text: str) -> dict:
    """{kernel: spill-store bytes} of each function ``-Xptxas -v`` reports
    with spills in ``text`` (build/.../ptxas.log); the flash kernels named
    by type, head_dim and tiling (``flash_fwd<f32,64,64x32>``), the others
    by their mangled names."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn and int(m.group(1)):
            out[flash_name(fn)] = int(m.group(1))
    return out


def flash_name(mangled: str) -> str:
    """A flash kernel's mangled name as plans.py names its launch (the
    one-pass probe variants marked), else the name itself."""
    m = re.search(r"(flash_fwd|flash_bwd_dq|flash_bwd_dkv)I(f|13__nv_bfloat16)"
                  r"Li(\d+)ELi(\d+)E(?:Li(\d+)E)?Lb([01])E", mangled)
    if not m:
        return mangled
    kind, t, dh, rows, bk, one = m.groups()
    bk = bk or "32"  # the backward's keys a tile
    name = f"{kind}<{'f32' if t == 'f' else 'bf16'},{dh},{rows}x{bk}>"
    return name + (" one_pass" if one == "1" else "")


def tiling_is_default(name: str) -> bool:
    """Whether a flash kernel named as :func:`flash_name` names it is its
    head_dim's default tiling (what the kernel had before its tilings)."""
    from repro_torch.kernels import plans
    m = re.match(r"flash_(fwd|bwd_dq|bwd_dkv)<\w+,(\d+),(\d+)x(\d+)>", name)
    if not m:
        return False
    table = plans.FLASH_FWD_TILINGS if m.group(1) == "fwd" \
        else plans.FLASH_BWD_TILINGS
    return table[int(m.group(2))][0] == (int(m.group(3)), int(m.group(4)))


def tiling_rows(torch, ops, args, kw, want, dh, G, iters, tol,
                tag) -> dict:
    """Every forward tiling at ``args`` (q, k, v, L; ``kw`` the mask),
    pinned through (block_q, block_k): {"bqxbk": its max abs error
    against the plain version's ``want`` (O, lse), its ms (CUDA events)}.
    Fails past ``tol``."""
    from repro_torch.kernels import plans
    out = {}
    for t in plans.flash_tilings(dh, G):
        bq, bk = plans.tiling_blocks(t, G)
        o, lse = ops.flash_attention(*args, block_q=bq, block_k=bk,
                                     return_lse=True, **kw)
        err = max(float((o - want[0]).abs().max()),
                  float((lse - want[1]).abs().max()))
        del o, lse
        if err > tol:
            fail(f"flash forward tiling {t} differs from plain at {tag}: "
                 f"{err}")
        out[f"{bq}x{bk}"] = dict(
            tiling=list(t), default=t == plans.FLASH_FWD_TILINGS[dh][0],
            max_abs_err=err, ms=timed(lambda: ops.flash_attention(
                *args, block_q=bq, block_k=bk, **kw), iters))
    return out


def bwd_tiling_rows(torch, ops, ref, args, kw, want, dh, G, iters,
                    tag) -> dict:
    """Every backward tiling at ``args`` (q, k, v, L, lse, delta, dO): {"bq
    xbk": dQ, dK, dV relative errors against the plain versions' ``want``
    and the dQ and dK/dV ms}.  Fails past BWD_REL_TOL."""
    from repro_torch.kernels import plans
    out = {}
    for t in plans.flash_tilings(dh, G, bwd=True):
        got = (ops.flash_attention_bwd_dq(*args, tiling=t, **kw),
               *ops.flash_attention_bwd_dkv(*args, tiling=t, **kw))
        errs = [float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                for g, w in zip(got, want)]
        del got
        if max(errs) > BWD_REL_TOL:
            fail(f"flash backward tiling {t} differs from plain at {tag}: "
                 f"{errs}")
        bq, bk = plans.tiling_blocks(t, G)
        out[f"{bq}x{bk}"] = dict(
            tiling=list(t), default=t == plans.FLASH_BWD_TILINGS[dh][0],
            max_rel_err=errs,
            dq_ms=timed(lambda: ops.flash_attention_bwd_dq(
                *args, tiling=t, **kw), iters),
            dkv_ms=timed(lambda: ops.flash_attention_bwd_dkv(
                *args, tiling=t, **kw), iters))
    return out


def check_tiling_variants(torch, ops, ref, dev):
    """Every forward and backward tiling, f32 and bf16, pinned, against
    the plain versions on a ragged-length and a window+softcap+length-1
    problem (the variant grid's second and fourth), and two calls
    bit-equal."""
    from repro_torch.kernels import plans
    gen = torch.Generator(device=dev).manual_seed(11)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128, 256):
            G = 2 if dh == 256 else 4
            for S, window, softcap, lens in FLASH_VARIANTS[1::2]:
                q, k, v = _attn(torch, dev, gen, 2, S, 2, G, dh, dtype)
                L = torch.tensor(lens, device=dev, dtype=torch.int32)
                kw = dict(window=window, softcap=softcap)
                ro, rlse = ref.flash_attention_ref(q, k, v, L, causal=True,
                                                   **kw)
                atol = 1e-4 if dtype == torch.float32 else 1.6e-2
                for t in plans.flash_tilings(dh, G):
                    bq, bk = plans.tiling_blocks(t, G)
                    got = [ops.flash_attention(
                        q, k, v, L, block_q=bq, block_k=bk, return_lse=True,
                        **kw) for _ in range(2)]
                    e_o = float((got[0][0].float() - ro.float()).abs().max())
                    e_l = float((got[0][1] - rlse).abs().max())
                    if e_o > atol or e_l > 1e-4 or not all(
                            torch.equal(a, b) for a, b in zip(*got)):
                        fail(f"flash forward tiling {t} {dtype} dh={dh} "
                             f"S={S}: O {e_o}, lse {e_l} or not bit-equal")
                    n += 1
                do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
                args = (q, k, v, L, rlse,
                        ref.flash_attention_delta(ro, do, 2), do)
                kwc = dict(kw, causal=True)
                want = (ref.flash_attn_bwd_dq_ref(*args, **kwc),
                        *ref.flash_attn_bwd_dkv_ref(*args, **kwc))
                for t in plans.flash_tilings(dh, G, bwd=True):
                    got = [(ops.flash_attention_bwd_dq(*args, tiling=t,
                                                       **kwc),
                            *ops.flash_attention_bwd_dkv(*args, tiling=t,
                                                         **kwc))
                           for _ in range(2)]
                    errs = [float((g - w).abs().max())
                            / max(1.0, float(w.abs().max()))
                            for g, w in zip(got[0], want)]
                    if max(errs) > BWD_REL_TOL or not all(
                            torch.equal(a, b) for a, b in zip(*got)):
                        fail(f"flash backward tiling {t} {dtype} dh={dh} "
                             f"S={S}: {errs} or not bit-equal")
                    n += 1
    emit("kernels.flash_tiling_variants", ok=True, checked=n,
         fwd_tilings={dh: [list(t) for t in ts]
                      for dh, ts in plans.FLASH_FWD_TILINGS.items()},
         bwd_tilings={dh: [list(t) for t in ts]
                      for dh, ts in plans.FLASH_BWD_TILINGS.items()})


def bwd_work(ref, q, k, L, dkv: bool, n_ops: float, window: int):
    """(FLOP, bytes) of one backward kernel call: ``n_ops * dh`` per live
    (query, key) pair; q, k, v, dO, lse, delta and lengths read once
    (f32), dQ or dK and dV written once."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    live = int(ref.attention_valid(S, L, window=window, causal=True).sum()) \
        * H                                        # live (query, key) pairs
    read = 4.0 * (2 * q.numel() + 2 * k.numel() + 2 * B * KV * S
                  * (H // KV) + L.numel())
    written = 4.0 * (2 * k.numel() if dkv else q.numel())
    return n_ops * dh * live, read + written


def check_flash_bwd_gemma(torch, ops, ref, dev, cfg, inputs, both, rel_err):
    """Both backward kernels at Gemma-2-2b's attention shape (head_dim 256,
    G 2, softcap) for the grad_gemma phase's B = 1 x GEMMA_GRAD_TOKENS: the
    local layers' window and the global layers' causal mask; against the
    plain version within BWD_REL_TOL, timed, with their record of their
    blocks, and on the global mask the one-pass TF32 control."""
    B, S = 1, GEMMA_GRAD_TOKENS
    KV, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    out = {"flash_attention_bwd_dq": {}, "flash_attention_bwd_dkv": {}}
    for layer, window in (("local", cfg.sliding_window), ("global", 0)):
        kw = dict(window=window, softcap=cfg.attn_softcap, causal=True)
        args = inputs(B, S, KV, G, dh, torch.float32, None, window,
                      cfg.attn_softcap)
        got, want = both(args, kw)
        errs = rel_err(got, want)
        if max(errs) > BWD_REL_TOL:
            fail(f"flash backward differs from plain at the gemma shape "
                 f"({layer}): dQ, dK, dV {errs}")
        blocks = bwd_blocks(torch, ops, args, kw, got, (B, KV))
        one_pass = bwd_one_pass(ops, args, kw, want, rel_err) \
            if layer == "global" else None
        del got, want
        q, k, _, L = args[:4]
        for name, dkv, n_ops, sl, fn in (
                ("flash_attention_bwd_dq", False, 6.0, slice(0, 1),
                 ops.flash_attention_bwd_dq),
                ("flash_attention_bwd_dkv", True, 8.0, slice(1, 3),
                 ops.flash_attention_bwd_dkv)):
            flop, n_bytes = bwd_work(ref, q, k, L, dkv, n_ops, window)
            tf_ms, tf_by = bound(n_bytes, 3 * flop, peak("peak_flops_tf32"))
            f32_ms, _ = bound(n_bytes, flop)
            ms = timed(lambda: fn(*args, **kw), 3)
            out[name][layer] = dict(
                shape=f"q [{B},{S},{KV * G},{dh}] f32, G={G}, softcap "
                      f"{cfg.attn_softcap}, window {window}",
                max_rel_err=max(errs[sl]), ms=ms, bound_ms=tf_ms,
                bound_by=tf_by, share_of_3xtf32_bound=tf_ms / ms,
                bound_f32_ms=f32_ms, share_of_f32_bound=f32_ms / ms,
                gflop=flop / 1e9, **blocks[name],
                **({} if one_pass is None else
                   {"one_pass_rel_err": max(one_pass[sl])}))
        del args
        torch.cuda.empty_cache()
    return out


def check_flash_decode(torch, ops, ref, dev, cfg, slots: int, S: int,
                       gemma):
    """The decode kernel against its plain version over the variant grid
    (two calls bit-equal, a length-0 row zeros) and at ``gemma``'s decode
    shapes in serve_gemma (a full rolling cache and the global one), then
    at the serving shape (``slots`` rows of a full ``S``-position f32
    cache): no attribute call in 100 steady calls, a CUDA graph's replay
    equal to the eager call, timed in turns with SDPA, its device half
    and its host split."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(6)

    def inputs(B, S, KV, G, dh, dtype):
        q = torch.randn(B, KV, G, dh, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, S, KV, dh, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        return q, k, v

    n_var, worst = 0, {"f32": 0.0, "bf16": 0.0}
    Sg = 700
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for G, dh in DECODE_LAYOUTS:
            for softcap in (0.0, 50.0):
                q, k, v = inputs(5, Sg, 2, G, dh, dtype)
                L = torch.tensor((Sg, 1, 300, 513, 0), device=dev,
                                 dtype=torch.int32)
                out = ops.flash_decode(q, k, v, L, softcap=softcap)
                want = ref.decode_attention_ref(q, k, v, L, softcap)
                rel = float((out.float() - want.float()).abs().max()) / \
                    float(want.float().abs().max())
                worst[name] = max(worst[name], rel)
                if rel > DECODE_REL_TOL[name]:
                    fail(f"flash_decode differs from plain: {dtype} G={G} "
                         f"dh={dh} softcap={softcap}: {rel}")
                if not torch.equal(ops.flash_decode(q, k, v, L,
                                                    softcap=softcap), out):
                    fail(f"flash_decode is not bit-equal over two calls: "
                         f"{dtype} G={G} dh={dh}")
                if not torch.equal(out[4], torch.zeros_like(out[4])):
                    fail("flash_decode: a length-0 row is not zeros")
                n_var += 1
    # serve_gemma's decode: rows at the lengths its two requests reach, on
    # the 4096-slot rolling cache and on the global one
    KV, G, dh = gemma.n_kv_heads, gemma.n_heads // gemma.n_kv_heads, \
        gemma.resolved_head_dim
    W, S_g = gemma.sliding_window, GEMMA_S_MAX
    top = [n + GEMMA_NEW for n in GEMMA_PROMPTS]
    gemma_rows = ((W, [min(n, W) for n in top]), (S_g, top))
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for Sc, lens in gemma_rows:
            q, k, v = inputs(len(lens), Sc, KV, G, dh, dtype)
            L = torch.tensor(lens, device=dev, dtype=torch.int32)
            out = ops.flash_decode(q, k, v, L, softcap=gemma.attn_softcap)
            want = ref.decode_attention_ref(q, k, v, L, gemma.attn_softcap)
            rel = float((out.float() - want.float()).abs().max()) / \
                float(want.float().abs().max())
            worst[name] = max(worst[name], rel)
            if rel > DECODE_REL_TOL[name]:
                fail(f"flash_decode differs from plain at gemma's shape: "
                     f"{dtype} S={Sc} lengths={lens}: {rel}")
            if not torch.equal(ops.flash_decode(
                    q, k, v, L, softcap=gemma.attn_softcap), out):
                fail(f"flash_decode is not bit-equal over two calls at "
                     f"gemma's shape: {dtype} S={Sc}")
            n_var += 1
    del q, k, v, out, want
    emit("kernels.flash_decode_variants", ok=True, checked=n_var,
         max_rel_err=worst, tol=DECODE_REL_TOL,
         repeat_bit_equal=True, length0_zero=True,
         grid="{f32,bf16} x (G,dh) in {(4,64),(6,128),(2,256),(1,64)} x "
              "softcap {0,50}; S=700, lengths (700, 1, 300, 513, 0)",
         gemma=f"{{f32,bf16}} x q [2,{KV},{G},{dh}], softcap "
               f"{gemma.attn_softcap}, cache {gemma_rows[0][0]} slots at "
               f"lengths {gemma_rows[0][1]} and {gemma_rows[1][0]} at "
               f"{gemma_rows[1][1]}")

    # the serving shape: every slot at the full cache length
    KV, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    q, k, v = inputs(slots, S, KV, G, dh, torch.float32)
    L = torch.full((slots,), S, device=dev, dtype=torch.int32)
    out = ops.flash_decode(q, k, v, L)
    want = ref.decode_attention_ref(q, k, v, L)
    err = float((out - want).abs().max())
    if err > DECODE_REL_TOL["f32"] * float(want.abs().max()):
        fail(f"flash_decode differs from plain at the serving shape: {err}")
    # steady calls ask the runtime for no attribute; one call captured in a
    # CUDA graph and replayed equals the eager call
    sets = attribute_sets("flash_decode_smem_state", dh, 0, G)
    for _ in range(100):
        ops.flash_decode(q, k, v, L)
    torch.cuda.synchronize()
    steady_sets = attribute_sets("flash_decode_smem_state", dh, 0, G) - sets
    if steady_sets:
        fail(f"flash_decode set a kernel attribute {steady_sets} times in "
             f"100 steady calls")
    if not torch.equal(decode_graph_replay(torch, ops, q, k, v, L), out):
        fail("flash_decode replayed from a CUDA graph differs from the "
             "eager call")
    n_bytes = 2.0 * int(L.sum()) * KV * dh * 4 + 4.0 * (q.numel()
                                                         + out.numel())
    b_ms, b_by = bound(n_bytes, 4.0 * dh * G * KV * int(L.sum()))
    # the library yardstick: SDPA with GQA and a boolean length mask
    qh = q.reshape(slots, KV * G, 1, dh)
    kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))
    mask = (torch.arange(S, device=dev)[None, :] < L[:, None])[:, None, None]

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              enable_gqa=True)

    row = timed_turns(lambda: ops.flash_decode(q, k, v, L), sdpa, 50)
    split = host_split_decode(torch, ops, q, k, v, L, sdpa)
    shape = (f"q [{slots},{KV},{G},{dh}], cache [{slots},{S},{KV},{dh}] "
             f"f32, lengths {S}")
    emit("kernels.flash_decode_turns", ok=True, shape=shape, ms=row["ms"],
         enqueue_ms=row["enqueue_ms"], sdpa_ms=row["library_ms"],
         device_ms_queued=split["device_us_queued"] / 1e3, bound_ms=b_ms,
         share_of_bound_device=b_ms / (split["device_us_queued"] / 1e3),
         ms_turns=row["ms_turns"], sdpa_ms_turns=row["library_ms_turns"],
         turns=TURNS, attribute_sets_in_100_steady_calls=steady_sets,
         graph_replay_equal=True, host_us=split)
    return {"flash_decode": dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **row,
        plain_ms=timed(lambda: ref.decode_attention_ref(q, k, v, L), 20),
        device_ms_queued=split["device_us_queued"] / 1e3, host_us=split,
        shape=shape, mbytes=n_bytes / 1e6)}


def flash_forward_row(torch, ops, ref, dev, gen, tag, B, S, KV, G, dh,
                      lens, tilings=False):
    """Row 3 at q [B, S, KV*G, dh] f32, causal, each row ``lens[b]`` long:
    held against its plain version (O and lse within 1e-4), timed (CUDA
    events) beside its plain version and SDPA's f32 call (is_causal where
    every row is full, else a boolean causal and length mask), with its
    bound over every live pair and, beside it, the bound over the pairs of
    real queries alone (the pad queries' outputs are dropped by the
    prefill).  With ``tilings``, every tiling of the kernel too
    (:func:`tiling_rows`)."""
    import torch.nn.functional as F
    q, k, v = _attn(torch, dev, gen, B, S, KV, G, dh, torch.float32)
    L = torch.tensor(lens, device=dev, dtype=torch.int32)
    o, lse = ops.flash_attention(q, k, v, L, return_lse=True)
    ro, rlse = ref.flash_attention_ref(q, k, v, L, window=0, softcap=0.0,
                                       causal=True)
    err = max(float((o - ro).abs().max()), float((lse - rlse).abs().max()))
    by_tiling = tiling_rows(torch, ops, (q, k, v, L), dict(), (ro, rlse),
                            dh, G, 10, 1e-4, f"{tag}'s shape") \
        if tilings else None
    del o, lse, ro, rlse
    if err > 1e-4:
        fail(f"flash differs from plain at {tag}'s shape: {err}")
    real = torch.arange(S, device=dev)[None, :] < L[:, None]
    valid = ref.attention_valid(S, L, window=0, causal=True)
    live = int(valid.sum()) * KV * G
    live_real = int((valid & real[:, :, None]).sum()) * KV * G
    H, n_real = KV * G, int(L.sum())
    b_ms, b_by = bound(4.0 * (2 * q.numel() + k.numel() + v.numel()
                              + B * H * S + B),
                       3 * 4.0 * dh * live, peak("peak_flops_tf32"))
    # real queries alone: their q, o and lse rows and the keys they see
    rb_ms, rb_by = bound(4.0 * (n_real * (2 * H * dh + 2 * KV * dh + H) + B),
                         3 * 4.0 * dh * live_real, peak("peak_flops_tf32"))
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    full = all(n == S for n in lens)
    mask = None if full else (
        torch.ones(S, S, device=dev, dtype=torch.bool).tril()[None]
        & real[:, None, :])[:, None]
    row = dict(
        shape=f"q [{B},{S},{H},{dh}] f32, causal, G={G}"
              + ("" if full else f", lengths {list(lens)}"),
        max_abs_err=err,
        ms=timed(lambda: ops.flash_attention(q, k, v, L), 10),
        plain_ms=timed(lambda: ref.flash_attention_ref(
            q, k, v, L, window=0, softcap=0.0, causal=True), 3),
        library_ms=timed(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=full, enable_gqa=True),
            10),
        library="SDPA f32, " + ("causal" if full
                                else "boolean causal and length mask"),
        bound_ms=b_ms, bound_by=b_by,
        real_query_pair_share=live_real / live,
        bound_real_queries_ms=rb_ms, bound_real_queries_by=rb_by,
        **({"tilings": by_tiling} if tilings else {}))
    del q, k, v, qh, kh, vh, mask
    return row


def flash_decode_row(torch, ops, ref, dev, gen, tag, S_cache, KV, G, dh,
                     lens):
    """Row 7 at q [B, KV, G, dh] over a [B, S_cache, KV, dh] f32 cache, row
    b ``lens[b]`` long: held against its plain version (DECODE_REL_TOL),
    timed beside its plain version and SDPA's f32 call with a length mask,
    and its bound."""
    import torch.nn.functional as F
    B = len(lens)
    q = torch.randn(B, KV, G, dh, generator=gen, device=dev)
    k, v = (torch.randn(B, S_cache, KV, dh, generator=gen, device=dev)
            for _ in range(2))
    L = torch.tensor(lens, device=dev, dtype=torch.int32)
    got = ops.flash_decode(q, k, v, L)
    want = ref.decode_attention_ref(q, k, v, L)
    rel = float((got - want).abs().max()) / float(want.abs().max())
    if rel > DECODE_REL_TOL["f32"]:
        fail(f"flash_decode differs from plain at {tag}'s cache: {rel}")
    n_bytes = 2.0 * int(L.sum()) * KV * dh * 4 + 4.0 * (q.numel()
                                                         + got.numel())
    b_ms, b_by = bound(n_bytes, 4.0 * dh * G * KV * int(L.sum()))
    qh = q.reshape(B, KV * G, 1, dh)
    kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))
    mask = (torch.arange(S_cache, device=dev)[None, :]
            < L[:, None])[:, None, None]
    row = dict(
        shape=f"q [{B},{KV},{G},{dh}], cache [{B},{S_cache},{KV},{dh}] f32, "
              f"lengths {list(lens)}",
        max_rel_err=rel, ms=timed(lambda: ops.flash_decode(q, k, v, L), 50),
        plain_ms=timed(lambda: ref.decode_attention_ref(q, k, v, L), 20),
        library_ms=timed(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, enable_gqa=True), 50),
        bound_ms=b_ms, bound_by=b_by)
    del q, k, v, qh, kh, vh, got, want
    return row


def check_new_shapes(torch, ops, ref, dev, qwen3, chatglm3):
    """Rows 3, 5-6 and 7 at the shapes of this slice's new configurations,
    each against its plain version, timed (CUDA events) beside its plain
    version, SDPA's f32 call and its bound: the forward at Qwen3-4B's ZO
    forward (B = CLIENT_BATCH, G 4, head_dim 128) and at ChatGLM3-6B's
    loss (OPTIONS_B x OPTIONS_S, G 16), the backward pair at Qwen3-4B's
    pre-training gradient (PRETRAIN_BATCH, G 4), decode at ChatGLM3-6B's
    served cache (G 16).  Returns {kernel: {config: row}}."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(8)
    out = {"flash_attention": {}, "flash_attention_bwd_dq": {},
           "flash_attention_bwd_dkv": {}, "flash_decode": {}}

    def layout(cfg):
        return (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                cfg.resolved_head_dim)

    for tag, cfg, B, S in (("qwen3", qwen3, CLIENT_BATCH, SEQ_LEN),
                           ("chatglm3", chatglm3, OPTIONS_B, OPTIONS_S)):
        out["flash_attention"][tag] = flash_forward_row(
            torch, ops, ref, dev, gen, tag, B, S, *layout(cfg), [S] * B,
            tilings=True)

    # the backward pair at Qwen3's pre-training gradient
    KV, G, dh = layout(qwen3)
    B, S = PRETRAIN_BATCH, SEQ_LEN
    q, k, v = _attn(torch, dev, gen, B, S, KV, G, dh, torch.float32)
    do = torch.randn(q.shape, generator=gen, device=dev)
    L = torch.full((B,), S, device=dev, dtype=torch.int32)
    o, lse = ref.flash_attention_ref(q, k, v, L, window=0, softcap=0.0,
                                     causal=True)
    args = (q, k, v, L, lse, ref.flash_attention_delta(o, do, KV), do)
    kw = dict(window=0, softcap=0.0, causal=True)
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    o_sdpa = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                            enable_gqa=True)
    lib_ms = timed(lambda: torch.autograd.grad(o_sdpa, (qh, kh, vh), doh,
                                               retain_graph=True), 10)
    del o_sdpa, qh, kh, vh, doh
    want = (ref.flash_attn_bwd_dq_ref(*args, **kw),
            *ref.flash_attn_bwd_dkv_ref(*args, **kw))
    bwd_tilings = bwd_tiling_rows(torch, ops, ref, args, kw, want, dh, G, 10,
                                  "qwen3's shape")
    del want
    for name, dkv, n_ops, fn, plain in (
            ("flash_attention_bwd_dq", False, 6.0,
             ops.flash_attention_bwd_dq, ref.flash_attn_bwd_dq_ref),
            ("flash_attention_bwd_dkv", True, 8.0,
             ops.flash_attention_bwd_dkv, ref.flash_attn_bwd_dkv_ref)):
        got, want = fn(*args, **kw), plain(*args, **kw)
        got, want = (got, want) if dkv else ((got,), (want,))
        rel = max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                  for g, w in zip(got, want))
        del got, want
        if rel > BWD_REL_TOL:
            fail(f"{name} differs from plain at qwen3's shape: {rel}")
        flop, n_bytes = bwd_work(ref, q, k, L, dkv, n_ops, 0)
        b_ms, b_by = bound(n_bytes, 3 * flop, peak("peak_flops_tf32"))
        out[name]["qwen3"] = dict(
            shape=f"q [{B},{S},{KV * G},{dh}] f32, causal, G={G}",
            max_rel_err=rel, ms=timed(lambda: fn(*args, **kw), 10),
            plain_ms=timed(lambda: plain(*args, **kw), 3),
            library_ms=lib_ms, library="SDPA f32 backward, dQ+dK+dV",
            bound_ms=b_ms, bound_by=b_by, tilings=bwd_tilings)
    del q, k, v, do, o, lse, args

    # decode at ChatGLM3's served cache: both rows at their last step
    out["flash_decode"]["chatglm3"] = flash_decode_row(
        torch, ops, ref, dev, gen, "chatglm3",
        max(CHATGLM_PROMPTS) + CHATGLM_NEW, *layout(chatglm3),
        [n + CHATGLM_NEW for n in CHATGLM_PROMPTS])
    emit("kernels.new_shapes", ok=True, **out)
    return out


def decode_graph_replay(torch, ops, q, k, v, L):
    """flash_decode(q, k, v, L) captured in a CUDA graph (after a warm call
    on the capture's side stream), replayed once: its output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_decode(q, k, v, L)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.flash_decode(q, k, v, L)
    graph.replay()
    torch.cuda.synchronize()
    return out


def host_split_decode(torch, ops, q, k, v, L, library):
    """Host us per call of flash_decode and of its pieces at the serving
    shape, and the device half: the kernel alone on preallocated operands,
    queued behind a spin kernel (``queued_ms``)."""
    from repro_torch.kernels import build
    lib = build.load()
    B, KV, G, dh = q.shape
    S = k.shape[1]
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), L.data_ptr(),
            out.data_ptr(), B, S, KV, G, dh, 0.0, dh ** -0.5, 0)
    st = ops._stream(q)
    return dict(
        device_us_queued=1e3 * queued_ms(
            torch, lambda s: lib.flash_decode(*args, s)),
        wrapper=host_us(lambda: ops.flash_decode(q, k, v, L)),
        wrapper_unrecorded=host_us(
            lambda: ops.flash_decode.__wrapped__(q, k, v, L)),
        on_cpu=host_us(lambda: ops._on_cpu(q, k, v)),
        lengths=host_us(lambda: ops._lengths(L, B, S, q)),
        empty_like=host_us(lambda: torch.empty_like(q)),
        ctypes_launch=host_us(lambda: lib.flash_decode(*args, st)),
        library=host_us(library),
        library_device_us_queued=1e3 * queued_ms(torch, lambda _: library()))


def mamba_inputs(torch, dev, gen, B, S, E, N):
    """Selective-scan operands with the Jamba layer's statistics at init:
    dt = softplus(dt_bias + noise) ~ 0.01 (the state decays little over S),
    A = -(1..N) scaled by a little noise, B, C and x standard normal."""
    import torch.nn.functional as F
    dt = F.softplus(0.5 * torch.randn(B, S, E, generator=gen, device=dev)
                    + float(torch.log(torch.expm1(torch.tensor(0.01)))))
    Bi, Ci = (torch.randn(B, S, N, generator=gen, device=dev)
              for _ in range(2))
    x = torch.randn(B, S, E, generator=gen, device=dev)
    A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32) * torch.exp(
        0.1 * torch.randn(E, N, generator=gen, device=dev))
    return dt, Bi, Ci, x, A


def check_mamba_scan(torch, ops, ref, dev):
    """The selective-scan kernel against its plain version over the variant
    grid (ragged S and E, one step, both state sizes, and the slice's
    shape), y and h_last each within MAMBA_SCAN_REL of its largest entry,
    two calls bit-equal; timed at the slice's shape."""
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    for B, S, E, N in MAMBA_VARIANTS:
        args = mamba_inputs(torch, dev, gen, B, S, E, N)
        y, h = ops.mamba_scan(*args)
        ry, rh = ref.mamba_scan_ref(*args)
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in ((y, ry), (h, rh))]
        worst = max(worst, *errs)
        if max(errs) > MAMBA_SCAN_REL:
            fail(f"mamba_scan differs from plain at (B, S, E, N) = "
                 f"{(B, S, E, N)}: y, h_last {errs}")
        y2, h2 = ops.mamba_scan(*args)
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            fail(f"mamba_scan is not bit-equal over two calls at "
                 f"{(B, S, E, N)}")
    emit("kernels.mamba_scan_variants", ok=True, max_rel_err=worst,
         tol=MAMBA_SCAN_REL, repeat_bit_equal=True,
         grid="(B, S, E, N) in " + str(list(MAMBA_VARIANTS)))

    # the slice's shape (the last variant): a client batch through one layer
    B, S, E, N = MAMBA_VARIANTS[-1]
    err = max(float((y - ry).abs().max()), float((h - rh).abs().max()))
    del y, h, ry, rh, y2, h2
    n_bytes = 4.0 * (3 * B * S * E + 2 * B * S * N + E * N + B * E * N)
    n_exp = float(B * S * E * N)
    mem_ms = n_bytes / peak("hbm_bw") * 1e3
    exp_ms = n_exp / EXP_PER_S * 1e3
    return {"mamba_scan": dict(
        max_abs_err=err, bound_ms=max(mem_ms, exp_ms),
        bound_by="bytes" if mem_ms >= exp_ms else "operations",
        bytes_bound_ms=mem_ms, exp_bound_ms=exp_ms, library_ms=None,
        **kernel_times(lambda: ops.mamba_scan(*args), 20),
        device_ms_queued=mamba_device_ms(torch, args),
        plain_ms=timed(lambda: ref.mamba_scan_ref(*args), 3),
        shape=f"dt, x [{B},{S},{E}] f32, N {N}", mbytes=n_bytes / 1e6,
        g_exp=n_exp / 1e9)}


def mamba_device_ms(torch, args) -> float:
    """The scan kernel alone on preallocated operands (dt, B, C, x, A),
    queued behind a spin kernel (``queued_ms``): its device half."""
    from repro_torch.kernels import build
    lib = build.load()
    dt = args[0]
    Bsz, S, E = dt.shape
    y = torch.empty_like(dt)
    h = torch.empty((Bsz, E, args[1].shape[-1]), dtype=torch.float32,
                    device=dt.device)
    ptrs = [t.data_ptr() for t in args] + [y.data_ptr(), h.data_ptr()]
    return queued_ms(torch, lambda s: lib.mamba_scan(
        *ptrs, Bsz, S, E, args[1].shape[-1], Bsz, s), calls=10)


def check_fixture_double(torch, ops, ref, dev):
    """The analyzer's fixture kernel: at FIXTURE_GOOD bit-equal to its plain
    version in blocks of FIXTURE_BLOCK_ROWS rows (32, then 128: the
    launcher's granted shared bytes rise; then ragged blocks of 50: they
    are reused, no cudaFuncSetAttribute); at FIXTURE_BAD in one block the
    card refuses the launch, the wrapper raises, nothing is counted, the
    granted bytes stay, and the next launch runs.  Timed at FIXTURE_GOOD,
    where one launch is all there is, in turns with torch.mul."""
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(*FIXTURE_GOOD, generator=gen, device=dev)
    want = ref.fixture_double_ref(x)
    states = [fixture_smem_state()]
    for block_rows in FIXTURE_BLOCK_ROWS:
        got = ops.fixture_double(x, block_rows)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fixture_double differs from plain at block_rows "
                 f"{block_rows}")
        states.append(fixture_smem_state())
    # the granted bytes rise to each size past the mark, and a size under
    # it asks the runtime nothing
    for (g0, s0), (g1, s1), rows in zip(states, states[1:],
                                        FIXTURE_BLOCK_ROWS):
        need = 2 * 4 * rows * FIXTURE_GOOD[1]
        if (g1, s1) != (max(g0, need), s0 + (need > g0)):
            fail(f"fixture_double's granted shared bytes went {g0, s0} -> "
                 f"{g1, s1} at block_rows {rows}")
    before = ops.fixture_double.launches
    xb = torch.randn(*FIXTURE_BAD, generator=gen, device=dev)
    refused = None
    try:
        ops.fixture_double(xb, FIXTURE_BAD[0])
    except RuntimeError as e:
        refused = str(e)
    if refused is None or ops.fixture_double.launches != before:
        fail("fixture_double's one-block launch at [2048, 2048] was not "
             "refused")
    after_refused = fixture_smem_state()
    if after_refused != (states[-1][0], states[-1][1] + 1):
        fail(f"the refused launch moved the granted shared bytes: "
             f"{states[-1]} -> {after_refused}")
    got = ops.fixture_double(x, FIXTURE_GOOD[0])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("fixture_double differs from plain after the refused launch")
    emit("kernels.fixture_double_variants", ok=True, bit_equal=True,
         block_rows=list(FIXTURE_BLOCK_ROWS), bad_refused=refused,
         granted_bytes_and_attribute_sets=states + [after_refused],
         smem_optin=torch.cuda.get_device_properties(
             dev).shared_memory_per_block_optin)
    n = x.numel()
    b_ms, b_by = bound(8.0 * n, float(n))
    return {"fixture_double": dict(
        max_abs_err=float((got - want).abs().max()), bound_ms=b_ms,
        bound_by=b_by,
        **timed_turns(lambda: ops.fixture_double(x, FIXTURE_GOOD[0]),
                      lambda: torch.mul(x, 2.0), 200),
        plain_ms=timed(lambda: ref.fixture_double_ref(x), 200),
        host_us=host_split_fixture(torch, ops, x),
        shape=f"{list(FIXTURE_GOOD)} f32, one block (launch latency)")}


def fixture_smem_state():
    """(dynamic shared bytes fixture_double's launcher holds granted for
    its 16-byte kernel on this device, cudaFuncSetAttribute calls so
    far)."""
    import ctypes
    from repro_torch.kernels import build
    out = (ctypes.c_longlong * 3)()
    rc = build.load().fixture_double_smem_state(out)
    if rc:
        fail(f"fixture_double_smem_state: CUDA error {rc}")
    return out[1], out[2]


def host_split_fixture(torch, ops, x):
    """Host us per call of fixture_double at FIXTURE_GOOD and of its
    pieces: where the host time of a call goes."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.load()
    y = torch.empty_like(x)
    st = ops._stream(x)
    state = (ctypes.c_longlong * 3)()
    args = (x.data_ptr(), y.data_ptr(), *FIXTURE_GOOD, FIXTURE_GOOD[0])
    return dict(
        device_us_queued=1e3 * queued_ms(
            torch, lambda s: lib.fixture_double(*args, s)),
        wrapper=host_us(lambda: ops.fixture_double(x, FIXTURE_GOOD[0])),
        wrapper_unrecorded=host_us(
            lambda: ops.fixture_double.__wrapped__(x, FIXTURE_GOOD[0])),
        on_cpu=host_us(lambda: ops._on_cpu(x)),
        empty_like=host_us(lambda: torch.empty_like(x)),
        ctypes_no_launch=host_us(
            lambda: lib.fixture_double_smem_state(state)),
        ctypes_refused_args=host_us(
            lambda: lib.fixture_double(*args[:2], 0, *args[3:], st)),
        ctypes_launch=host_us(lambda: lib.fixture_double(*args, st)),
        library=host_us(lambda: torch.mul(x, 2.0)),
        library_device_us_queued=1e3 * queued_ms(
            torch, lambda _: torch.mul(x, 2.0)))


# ------------------------------------------------------------------- slice --
def phase_clock(torch, on_card):
    """(done, times, peaks, resident): ``done(name, t0)`` records the phase's
    wall time, its peak device memory and what stays allocated after it."""
    times, peaks, resident = {}, {}, {}

    def done(name, t0):
        if on_card:
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() / 1e9
            resident[name] = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
        times[name] = time.perf_counter() - t0

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    return done, times, peaks, resident


def named_leaves(tree, prefix=""):
    """(path, leaf) pairs of a parameter tree, in the port's leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def mask_overlap(torch, a, b, params) -> float:
    """Share of space a's coordinates that space b selects too."""
    def flat(space):
        off, out = 0, []
        for idx, leaf in zip(named_leaves(space.idx_tree),
                             named_leaves(params)):
            out.append(idx[1] + off)
            off += leaf[1].numel()
        return torch.cat(out)
    fa = flat(a)
    return float(torch.isin(fa, flat(b)).sum()) / max(1, fa.numel())


def run_slice(torch, dev, cfg, *, t_cali=T_CALI, rounds=ROUNDS,
              label="slice", profile="zo_step"):
    """The slice on ``cfg`` through the port's public API: VP calibration
    of ``t_cali`` steps (none at 0), then ``rounds`` rounds with GradIP;
    emitted as ``label``, its profiled ZO step as ``profile.<profile>``
    (none when ``profile`` is None).  Where ``cfg`` has attention layers,
    the kernel attention route's mask and gradient are held against the
    dense route's; a model without them has nothing to hold, and the
    phase line gives null for both.  Returns (launch counts over the
    run, the counts the run implies)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import FLConfig
    from repro_torch.core.dispatch import get_backing, resolve_backend
    from repro_torch.core.gradip import grad_tree
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  make_task_fns, pretrain_batches,
                                  sample_dataset, subset)
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelCtx

    on_card = dev.type == "cuda"
    n_attn = n_mixers(cfg, "attn", "local_attn")
    dense_check = n_attn > 0
    phase_done, times, peaks, resident = phase_clock(torch, on_card)
    t0 = time.perf_counter()
    # one model for every pass: forwards and, under autograd, the backward
    # go through the flash kernels
    model = Model(cfg, ModelCtx(attn_backend="kernel"), device=dev)
    # the dense attention route, only to hold the kernel route against
    dense = Model(cfg, ModelCtx(attn_backend="dense"), device=dev)
    params = model.init(seed=SEED)
    spec = TaskSpec(vocab=512, seq_len=SEQ_LEN)
    loss, _, evaluate = make_task_fns(model, spec)
    train = sample_dataset(spec, 1024, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=N_CLIENTS,
                                alpha=0.5)
    clients = [C.Client(k, subset(train, p), batch_size=CLIENT_BATCH)
               for k, p in enumerate(parts)]
    ev = sample_dataset(spec, EVAL_EXAMPLES, seed=2)
    pre = pretrain_batches(spec, n_batches=PRETRAIN_BATCHES,
                           batch_size=PRETRAIN_BATCH)
    phase_done("setup", t0)

    ops.reset_launches()  # the main path starts here
    t0 = time.perf_counter()
    m0 = {k: float(v) for k, v in evaluate(params, ev).items()}
    phase_done("eval_before", t0)

    t0 = time.perf_counter()
    space = C.sensitivity_mask(lambda p, b: model.loss(p, b), params, pre,
                               density=DENSITY, device=dev)
    phase_done("mask", t0)

    # the kernel route against the dense one: the mask, and the whole-model
    # LM-loss gradient of one pre-training batch, leaf by leaf
    overlap = grad_rel = None
    if dense_check:
        t0 = time.perf_counter()
        dense_space = C.sensitivity_mask(lambda p, b: dense.loss(p, b),
                                         params, pre, density=DENSITY,
                                         device=dev)
        overlap = mask_overlap(torch, space, dense_space, params)
        del dense_space
        phase_done("mask_dense", t0)
        t0 = time.perf_counter()
        gk = grad_tree(lambda p, b: model.loss(p, b), params, pre[0])
        phase_done("grad_kernel", t0)
        t0 = time.perf_counter()
        gd = grad_tree(lambda p, b: dense.loss(p, b), params, pre[0])
        grad_rel = {
            name: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for (name, a), (_, b) in zip(named_leaves(gk),
                                         named_leaves(gd))}
        del gk, gd
        phase_done("grad_dense", t0)

    fl = FLConfig(n_clients=N_CLIENTS, local_steps=1, eps=1e-3,
                  density=DENSITY, zo_backend="kernel", vp_init_steps=2,
                  vp_later_steps=2, vp_sigma_relative=True, seed=SEED)
    # the route "auto" would take: the flat kernels while their six dense
    # f32 vectors fit in half of the card (core/dispatch.py)
    auto_backend = resolve_backend("auto", get_backing(space, params))
    server = C.FederatedZO(loss, params, space, fl, clients,
                           eval_fn=evaluate, device=dev)
    t0 = time.perf_counter()
    gp = C.pretrain_gradient_vec(lambda p, b: model.loss(p, b), params,
                                 space, pre)
    phase_done("pretrain_gradient", t0)
    flagged, trajs = [], []
    if t_cali:
        t0 = time.perf_counter()
        _, flagged, trajs = server.calibrate_vp(gp, T_cali=t_cali)
        phase_done("calibrate_vp", t0)
    t0 = time.perf_counter()
    server.run(rounds, gp_vec=gp)
    phase_done("rounds", t0)
    t0 = time.perf_counter()
    m1 = {k: float(v) for k, v in evaluate(server.params, ev).items()}
    phase_done("eval_after", t0)

    # one client's own trajectory against the server's replay of its scalar
    t0 = time.perf_counter()
    run = C.make_local_run(loss, space, fl.eps, fl.lr, backend="kernel")
    keys = C.round_keys(fl.seed, server.round, 1)
    batches = {k: torch.as_tensor(v, device=dev)
               for k, v in clients[0].next_batches(1).items()}
    delta, gs = run(server.params, keys, batches,
                    torch.zeros(space.n, device=dev))
    rec = C.reconstruct_delta(space, keys, gs.cpu().numpy(), fl.lr)
    rel = float((delta - rec).abs().max() / rec.abs().max())
    replay_ok = bool(torch.allclose(delta, rec, rtol=1e-6,
                                    atol=1e-6 * float(rec.abs().max())))
    phase_done("replay_check", t0)
    counts = ops.launches()  # the main path ends here

    n_steps = N_CLIENTS * t_cali + rounds * N_CLIENTS + 1
    n_forwards = 2 * n_steps + 2  # two per ZO step, plus the two evals
    # differentiated passes on the kernel route: mask and pre-training
    # gradient batches, and the gradient check's one
    n_grads = 2 * PRETRAIN_BATCHES + int(dense_check)
    expected = {name: 0 for name in counts}
    expected.update({"zo_dual_perturb_flat": n_steps,
                     "zo_fused_update_flat": n_steps,
                     "gradip_flat": N_CLIENTS * t_cali + rounds * N_CLIENTS,
                     "flash_attention": n_attn * (n_forwards + n_grads),
                     "flash_attention_bwd_dq": n_attn * n_grads,
                     "flash_attention_bwd_dkv": n_attn * n_grads})
    scalars = [g for h in server.gradip_log.values() for g in h]
    finite = (all(np.isfinite(v) for v in (*m0.values(), *m1.values()))
              and all(np.all(np.isfinite(t)) for t in trajs)
              and all(np.all(np.isfinite(g)) for g in scalars)
              and bool(torch.isfinite(gp).all())
              and bool(torch.isfinite(gs).all()))
    grad_max = max(grad_rel.values()) if dense_check else None
    emit(label, model=cfg.name, n_layers=cfg.n_layers,
         n_params=model.n_params, n_pad=get_backing(space, params).n_pad,
         auto_backend=auto_backend,
         mask_coords=space.n, clients=N_CLIENTS, client_batch=CLIENT_BATCH,
         seq_len=SEQ_LEN, T_cali=t_cali, rounds=rounds, flagged=flagged,
         eval_before=m0, eval_after=m1, up_bytes=server.comm.up_bytes,
         down_bytes=server.comm.down_bytes, launches=counts,
         expected_launches=expected, replay_max_rel_err=rel,
         replay_ok=replay_ok, finite=finite,
         mask_overlap_kernel_vs_dense=overlap,
         mask_overlap_min=MASK_OVERLAP_MIN,
         grad_rel_kernel_vs_dense=grad_rel,
         grad_rel_max=grad_max, grad_rel_bound=GRAD_REL_BOUND,
         times_s=times, round_s=times["rounds"] / rounds,
         zo_step_s=times["rounds"] / (rounds * N_CLIENTS),
         peak_gb=peaks, resident_gb=resident,
         max_memory_allocated_gb=max(peaks.values(), default=None))
    if not finite:
        fail(f"non-finite loss, scalar or GradIP in {label}")
    if not replay_ok:
        fail(f"{label}: client delta and server replay differ (max rel "
             f"{rel})")
    if dense_check and grad_max > GRAD_REL_BOUND:
        fail(f"{label}: kernel-route gradient differs from the dense "
             f"route's: {grad_rel} > {GRAD_REL_BOUND}")
    if dense_check and overlap < MASK_OVERLAP_MIN:
        fail(f"{label}: kernel-route mask overlaps the dense-route mask by "
             f"{overlap}")
    if on_card and auto_backend != "kernel":
        fail(f"{label}: zo_backend 'auto' leaves the flat kernels "
             f"({auto_backend!r})")
    if on_card and profile:
        profile_step(torch, profile, lambda: run(
            server.params, keys, batches, torch.zeros(space.n, device=dev)))
    return counts, expected


def n_mixers(cfg, *kinds) -> int:
    """Layers of ``cfg`` whose mixer is one of ``kinds``."""
    return cfg.n_periods * sum(m in kinds for m, _ in cfg.layer_pattern)


# ------------------------------------------------------------------- fleet --
def same_round_info(a, b) -> bool:
    """``last_round_info`` of two servers equal, the arrived scalars bit
    for bit."""
    import numpy as np
    if {k: v for k, v in a.items() if k != "arrived"} != \
            {k: v for k, v in b.items() if k != "arrived"}:
        return False
    return len(a["arrived"]) == len(b["arrived"]) and all(
        x[:2] == y[:2] and np.array_equal(x[2], y[2])
        for x, y in zip(a["arrived"], b["arrived"]))


def same_server_state(torch, a, b) -> dict:
    """Bit-equality of two servers' state, field by field (a server on a
    mesh by its gathered parameters)."""
    import numpy as np

    from repro_torch.utils.tree import tree_leaves

    def same_log(x, y):
        return len(x) == len(y) and all(
            (u is None) == (v is None)
            and (u is None or np.array_equal(u, v)) for u, v in zip(x, y))

    return dict(
        params=all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a.full_params()),
                       tree_leaves(b.full_params()))),
        gradip_log=all(same_log(a.gradip_log[c], b.gradip_log[c])
                       for c in a.gradip_log),
        comm=(a.comm.up_bytes, a.comm.down_bytes)
        == (b.comm.up_bytes, b.comm.down_bytes),
        pending=len(a._pending) == len(b._pending) and all(
            all(p[k] == q[k] for k in ("arrive", "cid", "src_round",
                                       "gip_idx"))
            and np.array_equal(p["gs"], q["gs"])
            for p, q in zip(a._pending, b._pending)),
        sampler=(a.sampler is None) == (b.sampler is None) and (
            a.sampler is None
            or a.sampler.state_dict() == b.sampler.state_dict()),
        flags=a.early_stopped == b.early_stopped,
        pointers=[c.ptr for c in a.clients] == [c.ptr for c in b.clients],
        round=a.round == b.round,
        last_round_info=same_round_info(a.last_round_info,
                                        b.last_round_info))


def run_fleet(torch, dev, cfg):
    """Phase 4b (module docstring) through ``FederatedZO.run``; returns
    (launch counts over the run, the counts its realized schedule
    implies)."""
    import os

    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import FLConfig
    from repro_torch.core.quantize import QuantSpec, wire_nbytes
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  make_task_fns, pretrain_batches,
                                  sample_dataset, subset)
    from repro_torch.fault import FaultPlan
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelCtx

    on_card = dev.type == "cuda"
    phase_done, times, peaks, resident = phase_clock(torch, on_card)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    model = Model(cfg, ModelCtx(attn_backend="kernel"), device=dev)
    params = model.init(seed=SEED)
    spec = TaskSpec(vocab=512, seq_len=SEQ_LEN)
    loss, _, _ = make_task_fns(model, spec)
    train = sample_dataset(spec, 1024, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=FLEET_CLIENTS,
                                alpha=0.5)
    pre = pretrain_batches(spec, n_batches=PRETRAIN_BATCHES,
                           batch_size=PRETRAIN_BATCH)
    fl = FLConfig(n_clients=FLEET_CLIENTS, local_steps=FLEET_T, eps=1e-3,
                  density=DENSITY, zo_backend="kernel", seed=SEED,
                  batch_size=CLIENT_BATCH, sample_frac=FLEET_FRAC,
                  quantize=FLEET_QUANTIZE)

    def plan():
        return FaultPlan(FLEET_CLIENTS, FLEET_ROUNDS, drop_rate=FLEET_DROP,
                         late_rate=FLEET_LATE, max_staleness=FLEET_STALENESS,
                         seed=FLEET_FAULT_SEED)

    def server(space, p):
        clients = [C.Client(k, subset(train, q), batch_size=CLIENT_BATCH)
                   for k, q in enumerate(parts)]
        return C.FederatedZO(loss, p, space, fl, clients, device=dev)

    phase_done("setup", t0)

    ops.reset_launches()  # the main path starts here
    t0 = time.perf_counter()
    space = C.sensitivity_mask(lambda p, b: model.loss(p, b), params, pre,
                               density=DENSITY, device=dev)
    gp = C.pretrain_gradient_vec(lambda p, b: model.loss(p, b), params,
                                 space, pre)
    phase_done("mask_and_gradient", t0)

    srv = server(space, params)
    fault_plan = plan()
    # one prompt client of round 0, run on its own from the same start: the
    # scalars it applies must be the server's decoded wire
    first = C.ClientSampler([c.cid for c in srv.clients], frac=FLEET_FRAC,
                            seed=SEED).cohort(0)
    f0 = fault_plan.round_faults(0).restrict(first)
    probe = next(c for c in first if c not in f0.drops and c not in f0.late)
    t0 = time.perf_counter()
    run = C.make_local_run(loss, space, fl.eps, fl.lr, backend="kernel",
                           quantize=QuantSpec(8))
    keys0 = C.round_keys(fl.seed, 0, FLEET_T)
    client = srv.clients[probe]
    batches = {k: torch.as_tensor(v, device=dev)
               for k, v in client.next_batches(FLEET_T).items()}
    client.ptr = 0
    probe_delta, applied = run(params, keys0, batches,
                               torch.zeros(space.n, device=dev))
    applied = applied.cpu().numpy()
    del batches, run
    phase_done("probe_client", t0)

    # the server: round 0 through run_round (its decoded uploads come back),
    # then FederatedZO.run a round at a time, the snapshot after round 2
    ckpt = ROOT / "build" / "fleet_ckpt" / "ckpt_fleet.msgpack"
    round_s, infos = [], []
    t_rounds = time.perf_counter()
    for r in range(FLEET_ROUNDS):
        if r == FLEET_ROUNDS // 2:
            phase_done("rounds_before_checkpoint", t_rounds)
            t0 = time.perf_counter()
            srv.save_checkpoint(str(ckpt))
            phase_done("checkpoint_write", t0)
            ckpt_bytes = ckpt.stat().st_size
            in_flight = [(p["cid"], p["src_round"], p["arrive"])
                         for p in srv._pending]
            t_rounds = time.perf_counter()
        t0 = time.perf_counter()
        if r == 0:
            gs0 = srv.run_round(gp_vec=gp,
                                faults=fault_plan.round_faults(0))
        else:
            srv.run(1, gp_vec=gp, fault_plan=fault_plan)
        sync()
        round_s.append(time.perf_counter() - t0)
        infos.append(srv.last_round_info)
    phase_done("rounds_after_checkpoint", t_rounds)

    # a fresh server from the same seed restores the snapshot and runs the
    # last rounds
    fresh = server(space, params)
    del params
    t0 = time.perf_counter()
    meta = fresh.load_checkpoint(str(ckpt))
    sync()
    phase_done("checkpoint_read", t0)
    restored_pending = len(fresh._pending)
    resumed_s = []
    t_rounds = time.perf_counter()
    for _ in range(FLEET_ROUNDS - FLEET_ROUNDS // 2):
        t0 = time.perf_counter()
        fresh.run(1, gp_vec=gp, fault_plan=plan())
        sync()
        resumed_s.append(time.perf_counter() - t0)
    phase_done("resumed_rounds", t_rounds)
    counts = ops.launches()  # the main path ends here
    os.remove(ckpt)

    same = same_server_state(torch, srv, fresh)
    wire = srv.codec.encode(gs0[probe])
    replay = C.reconstruct_from_wire(space, keys0, wire, srv.codec, fl.lr)
    rel = float((probe_delta - replay).abs().max() / replay.abs().max())
    replay_ok = bool(torch.allclose(probe_delta, replay, rtol=1e-6,
                                    atol=1e-6 * float(replay.abs().max())))
    applied_ok = np.array_equal(applied.view(np.int32),
                                gs0[probe].view(np.int32))
    del probe_delta, replay

    # the realized schedule: client runs, uploads landed, trajectories
    ran = ([len(i["cohort"]) - len(i["drops"]) for i in infos]
           + [len(i["cohort"]) - len(i["drops"]) for i in infos[2:]])
    reported = ([i["n_reporting"] for i in infos]
                + [i["n_reporting"] for i in infos[2:]])
    runs = sum(ran) + 1  # the probe client
    n_grads = 2 * PRETRAIN_BATCHES  # mask and pre-training gradient
    expected = {name: 0 for name in counts}
    expected.update({
        "zo_dual_perturb_flat": FLEET_T * runs,
        "zo_fused_update_flat": FLEET_T * runs,
        "gradip_flat": FLEET_T * sum(reported),
        "flash_attention": cfg.n_layers * (2 * FLEET_T * runs + n_grads),
        "flash_attention_bwd_dq": cfg.n_layers * n_grads,
        "flash_attention_bwd_dkv": cfg.n_layers * n_grads})
    up_wire = wire_nbytes(FLEET_T, 8)
    n_uploads = sum(i["n_reporting"] for i in infos)
    drops = sum(len(i["drops"]) for i in infos)
    lates = sum(len(i["late"]) for i in infos)
    finite = (all(np.all(np.isfinite(e)) for h in srv.gradip_log.values()
                  for e in h if e is not None)
              and bool(torch.isfinite(gp).all()))
    emit("fleet", model=cfg.name, n_params=model.n_params,
         mask_coords=space.n, clients=FLEET_CLIENTS, cohort=srv.sampler.m,
         T=FLEET_T, client_batch=CLIENT_BATCH, seq_len=SEQ_LEN,
         rounds=FLEET_ROUNDS, quantize=FLEET_QUANTIZE,
         fault_seed=FLEET_FAULT_SEED, drops=drops, lates=lates,
         unsampled=sum(i["n_unsampled"] for i in infos),
         cohorts=[i["cohort"] for i in infos],
         in_flight_at_checkpoint=in_flight,
         restored_pending=restored_pending, checkpoint_round=meta["round"],
         checkpoint_bytes=ckpt_bytes,
         checkpoint_write_s=times["checkpoint_write"],
         checkpoint_read_s=times["checkpoint_read"],
         round_s=round_s, resumed_round_s=resumed_s,
         up_bytes=srv.comm.up_bytes, uploads=n_uploads,
         up_bytes_per_upload=up_wire, raw_bytes_per_upload=4 * FLEET_T,
         down_bytes=srv.comm.down_bytes, bitequal=same,
         probe_client=probe, probe_applied_is_wire=applied_ok,
         probe_replay_max_rel_err=rel, probe_replay_ok=replay_ok,
         finite=finite, launches=counts, expected_launches=expected,
         times_s=times, peak_gb=peaks, resident_gb=resident,
         max_memory_allocated_gb=max(peaks.values(), default=None))
    if not all(same.values()):
        fail(f"resumed server differs from the uninterrupted one: {same}")
    if drops < 1 or not any(a >= FLEET_ROUNDS // 2 and a < FLEET_ROUNDS
                            for _, _, a in in_flight):
        fail(f"fleet schedule lacks a drop ({drops}) or a straggler landing "
             f"after the checkpoint ({in_flight})")
    if srv.comm.up_bytes != up_wire * n_uploads:
        fail(f"uplink billed {srv.comm.up_bytes} bytes for {n_uploads} "
             f"uploads of {up_wire}")
    if not applied_ok:
        fail(f"client {probe} applied {applied}, the server decoded "
             f"{gs0[probe]}")
    if not replay_ok:
        fail(f"client delta and wire replay differ (max rel {rel})")
    if not finite:
        fail("non-finite GradIP or pre-training gradient in the fleet")
    return counts, expected


# ------------------------------------------------------------------- mesh --
def run_mesh(torch, dev, cfg):
    """Phase 4f (module docstring) on one rank of a process group
    (``launch/mesh.process_group``: NCCL on the card, gloo on the CPU);
    returns (launch counts over the run, the counts it implies)."""
    from repro_torch.launch.mesh import process_group
    with process_group(dev.type):
        return _run_mesh(torch, dev, cfg)


def _run_mesh(torch, dev, cfg):
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import FLConfig
    from repro_torch.core import prng
    from repro_torch.core.fl_step import make_fl_train_loop
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  make_task_fns, pretrain_batches,
                                  sample_dataset, subset)
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import HW_CARD, step_model_flops
    from repro_torch.models import Model, ModelCtx
    from repro_torch.sharding.fl import make_fl_plan
    from repro_torch.utils.tree import tree_leaves

    on_card = dev.type == "cuda"
    phase_done, times, peaks, resident = phase_clock(torch, on_card)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = Model(cfg, ModelCtx(attn_backend="kernel"), device=dev)
    params = model.init(seed=SEED)
    spec = TaskSpec(vocab=512, seq_len=SEQ_LEN)
    loss, _, _ = make_task_fns(model, spec)
    train = sample_dataset(spec, 1024, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=N_CLIENTS,
                                alpha=0.5)
    pre = pretrain_batches(spec, n_batches=PRETRAIN_BATCHES,
                           batch_size=PRETRAIN_BATCH)
    fl = FLConfig(n_clients=N_CLIENTS, local_steps=1, eps=1e-3,
                  density=DENSITY, zo_backend="kernel", vp_init_steps=1,
                  vp_later_steps=1, vp_sigma_relative=True, seed=SEED)
    plans = {rule: make_fl_plan(spec=MESH_SPEC, rule=rule)
             for rule in ("fsdp", "replicate")}

    def server(space, plan=None):
        clients = [C.Client(k, subset(train, q), batch_size=CLIENT_BATCH)
                   for k, q in enumerate(parts)]
        return C.FederatedZO(loss, params, space, fl, clients, device=dev,
                             plan=plan)

    phase_done("setup", t0)

    ops.reset_launches()  # the main path starts here
    t0 = time.perf_counter()
    space = C.sensitivity_mask(lambda p, b: model.loss(p, b), params, pre,
                               density=DENSITY, device=dev)
    gp = C.pretrain_gradient_vec(lambda p, b: model.loss(p, b), params,
                                 space, pre)
    phase_done("mask_and_gradient", t0)

    def drive(srv, rounds, calibrate=True):
        """VP calibration (unless told not to), then ``rounds`` rounds with
        GradIP; (seconds, launches of each kernel, the gathered parameters
        after each round)."""
        before = ops.launches()
        t = time.perf_counter()
        if calibrate:
            srv.calibrate_vp(gp, T_cali=MESH_T_CALI)
        sync()
        secs = {"calibrate": time.perf_counter() - t, "rounds": [],
                "gathers": []}
        after = []
        for _ in range(rounds):
            t = time.perf_counter()
            srv.run_round(gp_vec=gp)
            sync()
            secs["rounds"].append(time.perf_counter() - t)
            t = time.perf_counter()
            after.append(srv.full_params())
            sync()
            secs["gathers"].append(time.perf_counter() - t)
        launches = {k: v - before[k] for k, v in ops.launches().items()}
        return secs, launches, after

    def same_params(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))

    # (1) unsharded and FSDP from the same state: VP calibration, 2 rounds
    t0 = time.perf_counter()
    ref = server(space)
    ref_s, ref_launches, ref_after = drive(ref, MESH_ROUNDS)
    phase_done("unsharded", t0)
    t0 = time.perf_counter()
    fsdp = server(space, plans["fsdp"])
    sync()
    place_s = time.perf_counter() - t0
    t = time.perf_counter()
    view = plans["fsdp"].compute_view(fsdp.params)
    sync()
    gather_ms = (time.perf_counter() - t) * 1e3
    del view
    fsdp_s, fsdp_launches, fsdp_after = drive(fsdp, MESH_ROUNDS)
    phase_done("fsdp", t0)
    same_fsdp = same_server_state(torch, ref, fsdp)
    gradip_finite = all(np.all(np.isfinite(e))
                        for h in ref.gradip_log.values() for e in h)
    same_fsdp["params_each_round"] = all(
        same_params(a, b) for a, b in zip(ref_after, fsdp_after))
    del fsdp_after

    # (2) one round under "replicate" from the same state (the unsharded
    # server's VP flags, as its calibration set them)
    t0 = time.perf_counter()
    rep = server(space, plans["replicate"])
    rep.early_stopped = set(ref.early_stopped)
    rep_s, rep_launches, rep_after = drive(rep, 1, calibrate=False)
    phase_done("replicate", t0)
    same_rep = same_params(rep_after[0], ref_after[0])
    del rep, rep_after, ref_after

    # (3) the FSDP server's checkpoint restored into an unsharded server;
    # one more round each
    ckpt = ROOT / "build" / "mesh_ckpt" / "ckpt_mesh.msgpack"
    t0 = time.perf_counter()
    fsdp.save_checkpoint(str(ckpt))
    phase_done("checkpoint_write", t0)
    ckpt_bytes = ckpt.stat().st_size
    t0 = time.perf_counter()
    twin = server(space)
    twin.load_checkpoint(str(ckpt))
    sync()
    phase_done("checkpoint_read", t0)
    ckpt.unlink()
    t0 = time.perf_counter()
    fsdp.run_round(gp_vec=gp)
    twin.run_round(gp_vec=gp)
    sync()
    phase_done("rounds_after_restore", t0)
    same_restored = same_server_state(torch, fsdp, twin)
    del fsdp, twin, ref

    # (4) make_fl_train_loop, the mesh route against none
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab, size=(MESH_LOOP_STEPS, N_CLIENTS * MESH_LOOP_BATCH,
                            SEQ_LEN), dtype=np.int32), device=dev)
    loop_out, loop_s = {}, {}
    for rule in (None, "fsdp"):
        t0 = time.perf_counter()
        plan = plans.get(rule)
        loop = make_fl_train_loop(
            lambda p, b: model.loss(p, b, per_example=True), space,
            eps=1e-3, lr=1e-2, n_clients=N_CLIENTS, n_steps=MESH_LOOP_STEPS,
            constrain_params=None if plan is None
            else plan.constrain_params_fn())
        p0 = params if plan is None else plan.place_params(params)
        p, g, _ = loop(p0, prng.key(1), {"tokens": tokens})
        sync()
        loop_s[rule or "none"] = time.perf_counter() - t0
        loop_out[rule] = (p if plan is None else plan.compute_view(p), g)
        del p0, p, loop
    phase_done("train_loop", t0)
    loop_param_err = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(loop_out[None][0]), tree_leaves(loop_out["fsdp"][0])))
    loop_g_err = float((loop_out[None][1] - loop_out["fsdp"][1]).abs().max())
    loop_finite = bool(torch.isfinite(loop_out["fsdp"][1]).all())
    del loop_out

    # (5) the roofline line: one client's ZO step (T=1, CLIENT_BATCH x
    # SEQ_LEN) timed, against its model FLOPs over the f32 peak
    run = C.make_local_run(loss, space, fl.eps, fl.lr, backend="kernel")
    keys = C.round_keys(fl.seed, 0, 1)
    client = C.Client(0, subset(train, parts[0]), batch_size=CLIENT_BATCH)
    batches = {k: torch.as_tensor(v, device=dev)
               for k, v in client.next_batches(1).items()}
    zeros = torch.zeros(space.n, device=dev)
    run(params, keys, batches, zeros)  # warm
    step_s = []
    for _ in range(MESH_ZO_STEPS):
        sync()
        t = time.perf_counter()
        run(params, keys, batches, zeros)
        sync()
        step_s.append(time.perf_counter() - t)
    counts = ops.launches()  # the main path ends here
    zo_s = statistics.median(step_s)
    flops = step_model_flops(cfg, CLIENT_BATCH, SEQ_LEN, "zo_step")
    f32 = peak("peak_flops_f32")
    emit("roofline", model=cfg.name, batch=CLIENT_BATCH, seq_len=SEQ_LEN,
         step="zo_step", model_flops=flops, zo_step_s=zo_s,
         zo_step_s_each=step_s, flop_per_s=flops / zo_s,
         peak_flops_f32=f32, mfu_f32=flops / zo_s / f32, peaks_of=HW_CARD,
         device=torch.cuda.get_device_name(0) if on_card else "cpu")

    n_grads = 2 * PRETRAIN_BATCHES  # mask and pre-training gradient
    server_steps = N_CLIENTS * MESH_T_CALI + MESH_ROUNDS * N_CLIENTS
    # ZO steps: two servers' calibration and rounds, the replicate round,
    # the two rounds after the restore, the loops and the timed steps
    zo_steps = (2 * server_steps + 3 * N_CLIENTS + 2 * MESH_LOOP_STEPS
                + MESH_ZO_STEPS + 1)
    n_attn = n_mixers(cfg, "attn", "local_attn")
    expected = {name: 0 for name in counts}
    expected.update({
        "zo_dual_perturb_flat": zo_steps,
        "zo_fused_update_flat": zo_steps,
        "gradip_flat": 2 * server_steps + 3 * N_CLIENTS,
        "flash_attention": n_attn * (2 * zo_steps + n_grads),
        "flash_attention_bwd_dq": n_attn * n_grads,
        "flash_attention_bwd_dkv": n_attn * n_grads})
    rows14 = ("zo_dual_perturb_flat", "zo_fused_update_flat",
              "flash_attention", "gradip_flat")
    launches_equal = all(ref_launches[k] == fsdp_launches[k] for k in rows14)
    finite = (loop_finite and gradip_finite
              and bool(torch.isfinite(gp).all()))
    emit("mesh", model=cfg.name, n_params=model.n_params,
         mask_coords=space.n, mesh=MESH_SPEC, ranks=1,
         backend="nccl" if on_card else "gloo", clients=N_CLIENTS,
         client_batch=CLIENT_BATCH, seq_len=SEQ_LEN, T_cali=MESH_T_CALI,
         rounds=MESH_ROUNDS, round_s={"unsharded": ref_s["rounds"],
                                      "fsdp": fsdp_s["rounds"],
                                      "replicate": rep_s["rounds"]},
         calibrate_s={"unsharded": ref_s["calibrate"],
                      "fsdp": fsdp_s["calibrate"]},
         gather_ms=gather_ms, place_s=place_s,
         gathers_after_rounds_s=fsdp_s["gathers"], bitequal_fsdp=same_fsdp,
         bitequal_replicate=same_rep, bitequal_restored=same_restored,
         checkpoint_bytes=ckpt_bytes,
         checkpoint_write_s=times["checkpoint_write"],
         checkpoint_read_s=times["checkpoint_read"],
         launches_unsharded={k: ref_launches[k] for k in rows14},
         launches_fsdp={k: fsdp_launches[k] for k in rows14},
         launches_replicate={k: rep_launches[k] for k in rows14},
         launches_equal=launches_equal, loop_s=loop_s,
         loop_max_abs_param_diff=loop_param_err,
         loop_max_abs_g_diff=loop_g_err,
         loop_atol=(MESH_LOOP_PARAM_ATOL, MESH_LOOP_G_ATOL),
         finite=finite, launches=counts, expected_launches=expected,
         times_s=times, peak_gb=peaks, resident_gb=resident,
         max_memory_allocated_gb=max(peaks.values(), default=None))
    if not all(same_fsdp.values()):
        fail(f"mesh: the FSDP server differs from the unsharded one: "
             f"{same_fsdp}")
    if not same_rep:
        fail("mesh: the replicate round differs from the unsharded one")
    if not all(same_restored.values()):
        fail(f"mesh: the restored unsharded server differs from the FSDP "
             f"one: {same_restored}")
    if not launches_equal:
        fail(f"mesh: launches {fsdp_launches} != unsharded {ref_launches}")
    if loop_param_err > MESH_LOOP_PARAM_ATOL or loop_g_err > MESH_LOOP_G_ATOL:
        fail(f"mesh: the train loop's mesh route is {loop_param_err} / "
             f"{loop_g_err} from the unsharded one")
    if not finite:
        fail("mesh: non-finite projected gradients or pre-training gradient")
    return counts, expected


# ----------------------------------------------------------------- tp --
def run_tp(torch, dev, cfg):
    """Phase tp (module docstring): tensor-parallel compute (``rule="tp"``)
    on one rank of a 1x1 mesh, then the ``dryrun`` line from fake groups;
    returns (launch counts over the run, the counts it implies)."""
    from repro_torch.launch.mesh import process_group
    with process_group(dev.type):
        counts, expected, real = _run_tp(torch, dev, cfg)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    run_dryrun_line(torch, dev, cfg, real)
    return counts, expected


def _run_tp(torch, dev, cfg):
    import dataclasses

    import repro_torch.core as C
    from repro_torch.configs import FLConfig
    from repro_torch.configs.base import InputShape
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  make_task_fns, sample_dataset, subset)
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import Model, ModelCtx
    from repro_torch.models.moe import moe_dense_ref, moe_sharded
    from repro_torch.sharding.fl import make_fl_plan
    from repro_torch.utils.tree import tree_leaves

    on_card = dev.type == "cuda"
    phase_done, times, peaks, resident = phase_clock(torch, on_card)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    plan = make_fl_plan(spec=MESH_SPEC, rule="tp")
    ctx = ModelCtx(attn_backend="kernel")
    model = Model(cfg, ctx, device=dev)
    params = model.init(seed=SEED)
    spec = TaskSpec(vocab=512, seq_len=SEQ_LEN)
    # the unsharded rounds under the plain ctx; the tp rounds under the
    # plan's (its mesh and batch axes), as launch/train.py builds them
    loss = make_task_fns(model, spec)[0]
    tp_loss = make_task_fns(Model(cfg, plan.model_ctx(ctx), device=dev),
                            spec)[0]
    train = sample_dataset(spec, 1024, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=N_CLIENTS,
                                alpha=0.5)
    fl = FLConfig(n_clients=N_CLIENTS, local_steps=1, eps=1e-3,
                  density=DENSITY, zo_backend="kernel", seed=SEED)
    space = C.random_mask(params, DENSITY, seed=SEED)
    phase_done("setup", t0)

    def drive(srv_plan, loss):
        clients = [C.Client(k, subset(train, q), batch_size=CLIENT_BATCH)
                   for k, q in enumerate(parts)]
        srv = C.FederatedZO(loss, params, space, fl, clients, device=dev,
                            plan=srv_plan)
        before = ops.launches()
        secs, after = [], []
        for _ in range(TP_ROUNDS):
            sync()
            t = time.perf_counter()
            srv.run_round()
            sync()
            secs.append(time.perf_counter() - t)
            after.append([x.clone() for x in tree_leaves(srv.full_params())])
        return secs, {k: v - before[k] for k, v in ops.launches().items()}, \
            after

    ops.reset_launches()  # the main path starts here
    t0 = time.perf_counter()
    ref_s, ref_launches, ref_after = drive(None, loss)
    phase_done("unsharded", t0)
    t0 = time.perf_counter()
    tp_s, tp_launches, tp_after = drive(plan, tp_loss)
    phase_done("tp_rounds", t0)
    errs = [max(float((a - b).abs().max()) for a, b in zip(x, y))
            for x, y in zip(ref_after, tp_after)]
    bitequal = all(all(torch.equal(a, b) for a, b in zip(x, y))
                   for x, y in zip(ref_after, tp_after))
    moved = any(not torch.equal(a, b)
                for a, b in zip(tree_leaves(params), ref_after[-1]))
    del ref_after, tp_after

    # Phi-3.5-MoE's layer at full width: moe_sharded on the 1x1 mesh (its
    # experts DTensors on the model sub-mesh) against moe_dense_ref
    t0 = time.perf_counter()
    phi = PHI35_MOE_CFG()
    lp = {k: v[0] for k, v in Model(phi, device=dev).init(seed=SEED)[
        "stack"]["p0"].items() if k in ("router", "w1", "w2", "w3")}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((TP_MOE_BATCH, SEQ_LEN, phi.d_model), generator=gen,
                    device=dev)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    sub = plan.mesh["model"]
    dp_ = {k: DTensor.from_local(v, sub, [Shard(0)] if k != "router"
                                 else [Replicate()], run_check=False)
           for k, v in lp.items()}
    ctx = plan.model_ctx(ModelCtx(use_sharded_moe=True))
    with torch.no_grad():
        want, aux_want = moe_dense_ref(x, lp, phi.moe, phi.act)
        got, aux_got = moe_sharded(x, dp_, phi.moe, phi.act, ctx)
        sync()
        t = time.perf_counter()
        moe_sharded(x, dp_, phi.moe, phi.act, ctx)
        sync()
        moe_ms = (time.perf_counter() - t) * 1e3
    moe_rel = float((got - want).abs().max() / want.abs().max())
    moe_aux_err = abs(float(aux_got) - float(aux_want))
    moe_params = sum(v.numel() for v in lp.values())
    del lp, dp_, x, want, got
    phase_done("moe", t0)

    # the dry run's own ZO step on this real rank (the record's program:
    # the tp step of core/fl_step, online attention under the mesh), timed
    # and its device-memory rise measured, for the dryrun line
    t0 = time.perf_counter()
    shape = InputShape("train_llama", seq_len=SEQ_LEN,
                       global_batch=CLIENT_BATCH, kind="train")
    idx = dryrun.mask_indices(cfg, dtype=torch.float32)[0]
    fn, args = dryrun.build_step(cfg, shape, plan.mesh, plan.mesh_cfg,
                                 "zo_fl", idx, dtype=torch.float32,
                                 device=dev)
    fn(*args)  # warm
    sync()
    step_s = []
    for _ in range(2):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        t = time.perf_counter()
        fn(*args)
        sync()
        step_s.append(time.perf_counter() - t)
    rise = (torch.cuda.max_memory_allocated() - base) if on_card else None
    real = dict(step_s=step_s, rise_bytes=rise)
    del fn, args
    phase_done("real_step", t0)
    counts = ops.launches()  # the main path ends here

    n_attn = n_mixers(cfg, "attn", "local_attn")
    steps = TP_ROUNDS * N_CLIENTS
    expected = {name: 0 for name in counts}
    # the same launches on each drive: one dual perturb, one update and
    # two forwards a client step
    per_drive = {"zo_dual_perturb_flat": steps, "zo_fused_update_flat": steps,
                 "flash_attention": 2 * steps * n_attn}
    expected.update({k: 2 * v for k, v in per_drive.items()})
    emit("tp", model=cfg.name, mesh=MESH_SPEC, ranks=1,
         backend="nccl" if on_card else "gloo", clients=N_CLIENTS,
         client_batch=CLIENT_BATCH, seq_len=SEQ_LEN, rounds=TP_ROUNDS,
         round_s={"unsharded": ref_s, "tp": tp_s}, bitequal=bitequal,
         max_abs_param_diff=errs, tol=(MESH_LOOP_PARAM_ATOL,
                                       MESH_LOOP_G_ATOL), moved=moved,
         launches_unsharded=ref_launches, launches_tp=tp_launches,
         shard_routes=("zo_dual_perturb_flat", "zo_fused_update_flat",
                       "flash_attention"),
         moe=dict(model=phi.name, layer_params=moe_params,
                  batch=TP_MOE_BATCH, seq_len=SEQ_LEN, rel_err=moe_rel,
                  aux_abs_err=moe_aux_err, tol=MOE_LOOP_REL,
                  sharded_ms=moe_ms),
         launches=counts, expected_launches=expected, times_s=times,
         peak_gb=peaks, resident_gb=resident)
    if not bitequal and max(errs) > MESH_LOOP_PARAM_ATOL:
        fail(f"tp: the tp rounds are {errs} from the unsharded ones")
    if not moved:
        fail("tp: the rounds left the parameters where they were")
    for k, v in per_drive.items():
        if on_card and (tp_launches[k], ref_launches[k]) != (v, v):
            fail(f"tp: {tp_launches[k]} {k} launches under tp and "
                 f"{ref_launches[k]} unsharded, not {v} each")
    if moe_rel > MOE_LOOP_REL or moe_aux_err > MOE_LOOP_REL:
        fail(f"tp: moe_sharded is {moe_rel} / {moe_aux_err} from "
             "moe_dense_ref")
    return counts, expected, real


def PHI35_MOE_CFG():
    """Phi-3.5-MoE cut to one of its 32 layers, at full width."""
    from repro_torch.configs import PHI35_MOE
    return PHI35_MOE.replace(n_layers=1)


def run_dryrun_line(torch, dev, cfg, real):
    """The ``dryrun`` line: the fake-group record of the tp phase's real
    ZO step (f32, CLIENT_BATCH x SEQ_LEN, 1x1) against the real run (its
    device-memory rise, its time), its FLOPs against the model's, its
    roofline bound at the f32 peak; then bf16 single-mesh records of
    qwen3-4b train_4k and kimi-k2 decode_32k, depth-1/2 extrapolated."""
    from repro_torch.configs.base import InputShape, MeshConfig
    from repro_torch.launch import dryrun, roofline
    t0 = time.perf_counter()
    shape = InputShape("train_llama", seq_len=SEQ_LEN,
                       global_batch=CLIENT_BATCH, kind="train")
    rec = dryrun.run_combo(cfg, shape, False, mc=MeshConfig(1, 1, 1),
                           dtype=torch.float32, full=True)
    if not rec["ok"]:
        fail(f"dryrun: the Llama record failed: {rec.get('error')}")
    hw_f32 = dict(roofline.HW, peak_flops_bf16=roofline.HW["peak_flops_f32"])
    row = roofline.analyze(rec, hw_f32)
    mem = rec["memory"]
    est = mem["peak_est_bytes"] - mem["argument_bytes"]
    rise = real["rise_bytes"]
    model_flops = roofline.step_model_flops(cfg, CLIENT_BATCH, SEQ_LEN,
                                            "zo_step")
    step_s = min(real["step_s"])
    others = {}
    for arch, shp in DRYRUN_SINGLE:
        r = dryrun.run_combo(arch, shp, False, full_budget=0)
        if not r["ok"]:
            fail(f"dryrun: {arch} {shp} failed: {r.get('error')}")
        a = roofline.analyze(r)
        others[f"{arch}|{shp}"] = dict(
            trace_s=r["compile_s"], flops=r["cost"]["flops"],
            bytes=r["cost"]["bytes"], collectives=r["collectives"],
            peak_est_bytes=r["memory"]["peak_est_bytes"],
            full_depth=r["full_depth"], dominant=a["dominant"],
            bound_s=max(a["compute_s"], a["memory_s"], a["collective_s"]))
    rel = None if rise is None else abs(est - rise) / rise
    emit("dryrun", model=cfg.name, mesh="1x1", dtype="float32",
         batch=CLIENT_BATCH, seq_len=SEQ_LEN, trace_s=rec["compile_s"],
         record_flops=rec["cost"]["flops"], model_flops=model_flops,
         flops_ratio=rec["cost"]["flops"] / model_flops,
         record_bytes=rec["cost"]["bytes"], memory=mem,
         peak_est_minus_args=est, measured_rise=rise, rise_rel_err=rel,
         rise_tol=AN_LIVENESS_REL, bound_s_at_f32_peak=max(
             row["compute_s"], row["memory_s"], row["collective_s"]),
         dominant=row["dominant"], measured_step_s=real["step_s"],
         bound_over_measured=max(row["compute_s"], row["memory_s"],
                                 row["collective_s"]) / step_s,
         fit_exact=rec.get("fit_exact"), single_mesh=others,
         peaks_of=roofline.HW_CARD, seconds=time.perf_counter() - t0)
    if rel is not None and rel > AN_LIVENESS_REL:
        fail(f"dryrun: peak_est {est} is {rel:.3f} from the measured rise "
             f"{rise}")


# --------------------------------------------------------------- lora --
def run_lora(torch, dev, cfg):
    """LoRA-FedZO with random early stopping on ``cfg`` (Llama-3.2-1B with
    rank-LORA_RANK adapters on q and v) through the port's public API:
    ``LoRASpace`` on the flat kernel route, which carries the whole model
    with the adapters among the base weights; the pre-training gradient at
    the adapter coordinates through the flash backward; LORA_EARLY_STOP
    clients early-stopped by ``early_stop_random``; LORA_ROUNDS rounds of
    N_CLIENTS Dirichlet clients at T=LORA_T with GradIP.  Returns (launch
    counts over the run, the counts the run implies)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import FLConfig
    from repro_torch.core.dispatch import get_backing
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  make_task_fns, pretrain_batches,
                                  sample_dataset, subset)
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelCtx
    from repro_torch.utils.tree import tree_flatten_with_keys

    on_card = dev.type == "cuda"
    phase_done, times, peaks, resident = phase_clock(torch, on_card)
    t0 = time.perf_counter()
    ctx = ModelCtx(attn_backend="kernel")
    model = Model(cfg, ctx, device=dev)
    params = model.init(seed=SEED)
    spec = TaskSpec(vocab=512, seq_len=SEQ_LEN)
    loss, _, evaluate = make_task_fns(model, spec)
    train = sample_dataset(spec, 1024, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=N_CLIENTS,
                                alpha=0.5)
    clients = [C.Client(k, subset(train, p), batch_size=CLIENT_BATCH)
               for k, p in enumerate(parts)]
    ev = sample_dataset(spec, EVAL_EXAMPLES, seed=2)
    pre = pretrain_batches(spec, n_batches=PRETRAIN_BATCHES,
                           batch_size=PRETRAIN_BATCH)
    # the base weights as they start, to hold the rounds to them
    base0 = {p: t.clone() for p, t in tree_flatten_with_keys(params)[0]
             if "lora_" not in p}
    # fresh adapters (B factors zero) leave the function unchanged: the
    # LoRA model's loss bit-equal to the base model's on a client batch
    base_model = Model(cfg.replace(lora_rank=0), ctx, device=dev)
    base_loss, _, _ = make_task_fns(base_model, spec)
    base_params = {k: v for k, v in params.items() if k != "stack"}
    base_params["stack"] = {
        i: {k: v for k, v in lp.items() if not k.startswith("lora_")}
        for i, lp in params["stack"].items()}
    b0 = {k: v[0] for k, v in clients[0].next_batches(1).items()}
    clients[0].ptr = 0
    with torch.no_grad():
        l_lora = loss(params, b0)
        l_base = base_loss(base_params, b0)
    loss_bit_equal = bool(torch.equal(l_lora, l_base))
    del base_params, base_model
    phase_done("setup", t0)

    ops.reset_launches()  # the main path starts here
    t0 = time.perf_counter()
    m0 = {k: float(v) for k, v in evaluate(params, ev).items()}
    phase_done("eval_before", t0)
    space = C.LoRASpace(params)
    backing = get_backing(space, params)
    fl = FLConfig(n_clients=N_CLIENTS, local_steps=LORA_T, lr=LORA_LR,
                  eps=1e-3, mask_kind="lora", zo_backend="kernel", seed=SEED)
    server = C.FederatedZO(loss, params, space, fl, clients,
                           eval_fn=evaluate, device=dev)
    t0 = time.perf_counter()
    gp = C.pretrain_gradient_vec(lambda p, b: model.loss(p, b), params,
                                 space, pre)
    phase_done("pretrain_gradient", t0)
    server.early_stop_random(LORA_EARLY_STOP, seed=LORA_STOP_SEED)
    t0 = time.perf_counter()
    steps = {}
    for _ in range(LORA_ROUNDS):
        for cid, g in server.run_round(gp_vec=gp).items():
            steps.setdefault(cid, []).append(len(g))
    phase_done("rounds", t0)
    t0 = time.perf_counter()
    m1 = {k: float(v) for k, v in evaluate(server.params, ev).items()}
    phase_done("eval_after", t0)

    # a client that runs LORA_T steps, against the server's replay
    t0 = time.perf_counter()
    cid = min(set(range(N_CLIENTS)) - server.early_stopped)
    run = C.make_local_run(loss, space, fl.eps, fl.lr, backend="kernel")
    keys = C.round_keys(fl.seed, server.round, LORA_T)
    batches = {k: torch.as_tensor(v, device=dev)
               for k, v in clients[cid].next_batches(LORA_T).items()}
    delta, gs = run(server.params, keys, batches,
                    torch.zeros(space.n, device=dev))
    rec = C.reconstruct_delta(space, keys, gs.cpu().numpy(), fl.lr)
    rel = float((delta - rec).abs().max() / rec.abs().max())
    replay_ok = bool(torch.allclose(delta, rec, rtol=1e-6,
                                    atol=1e-6 * float(rec.abs().max())))
    phase_done("replay_check", t0)
    counts = ops.launches()  # the main path ends here

    t0 = time.perf_counter()
    base_kept = all(torch.equal(t, base0[p]) for p, t in
                    tree_flatten_with_keys(server.params)[0]
                    if "lora_" not in p)
    del base0
    phase_done("base_check", t0)
    want_steps = {c: [1 if c in server.early_stopped else LORA_T]
                  * LORA_ROUNDS for c in range(N_CLIENTS)}
    n_round_steps = sum(sum(v) for v in want_steps.values())
    n_steps = n_round_steps + LORA_T  # and the replayed client's
    expected = {name: 0 for name in counts}
    expected.update({"zo_dual_perturb_flat": n_steps,
                     "zo_fused_update_flat": n_steps,
                     "gradip_flat": n_round_steps,
                     # two forwards a ZO step, the two evals, and the
                     # pre-training gradient's batches under autograd
                     "flash_attention": cfg.n_layers * (
                         2 * n_steps + 2 + PRETRAIN_BATCHES),
                     "flash_attention_bwd_dq": cfg.n_layers
                     * PRETRAIN_BATCHES,
                     "flash_attention_bwd_dkv": cfg.n_layers
                     * PRETRAIN_BATCHES})
    up_want = 4 * n_round_steps
    down_want = 4 * space.n * N_CLIENTS * LORA_ROUNDS
    scalars = [g for h in server.gradip_log.values() for g in h]
    finite = (all(np.isfinite(v) for v in (*m0.values(), *m1.values()))
              and all(np.all(np.isfinite(g)) for g in scalars)
              and bool(torch.isfinite(gp).all())
              and bool(torch.isfinite(gs).all()))
    emit("lora", model=cfg.name, lora_rank=cfg.lora_rank,
         lora_alpha=cfg.lora_alpha, n_params=model.n_params,
         lora_coords=space.n, n_flat=backing.n_flat, n_pad=backing.n_pad,
         clients=N_CLIENTS, client_batch=CLIENT_BATCH, seq_len=SEQ_LEN,
         T=LORA_T, lr=LORA_LR, rounds=LORA_ROUNDS,
         early_stopped=sorted(server.early_stopped), steps=steps,
         loss_lora_vs_base_bit_equal=loss_bit_equal, loss_before=float(
             l_lora), base_weights_unchanged=base_kept,
         gp_zero_share=float((gp == 0).float().mean()),
         eval_before=m0, eval_after=m1, up_bytes=server.comm.up_bytes,
         up_bytes_want=up_want, down_bytes=server.comm.down_bytes,
         down_bytes_want=down_want, launches=counts,
         expected_launches=expected, replay_max_rel_err=rel,
         replay_ok=replay_ok, finite=finite, times_s=times,
         round_s=times["rounds"] / LORA_ROUNDS,
         zo_step_s=times["rounds"] / n_round_steps, peak_gb=peaks,
         resident_gb=resident,
         max_memory_allocated_gb=max(peaks.values(), default=None))
    if space.n != 16 * (2 * 2048 * 4 + 4 * 2048 + 4 * 512) and \
            cfg.n_layers == 16:
        fail(f"lora: LoRASpace holds {space.n} coordinates")
    if not loss_bit_equal:
        fail(f"lora: the fresh LoRA model's loss {float(l_lora)} is not "
             f"bit-equal to the base model's {float(l_base)}")
    if not base_kept:
        fail("lora: a base weight moved in the LoRA-FedZO rounds")
    if steps != want_steps:
        fail(f"lora: local steps {steps} != {want_steps}")
    if (server.comm.up_bytes, server.comm.down_bytes) != (up_want,
                                                           down_want):
        fail(f"lora: bytes up/down {server.comm.up_bytes}/"
             f"{server.comm.down_bytes} != {up_want}/{down_want}")
    if not finite:
        fail("non-finite loss, scalar or GradIP in lora")
    if not replay_ok:
        fail(f"lora: client delta and server replay differ (max rel {rel})")
    return counts, expected


def run_slice_qwen3(torch, dev, cfg):
    """MEERKAT on Qwen3-4B at full width, QWEN3_LAYERS layers (qk-norm,
    head_dim 128, G 4): the slice's mask, pre-training gradient and
    kernel-vs-dense checks, then QWEN3_ROUNDS rounds with GradIP and no VP
    calibration (``run_slice``)."""
    return run_slice(torch, dev, cfg, t_cali=0, rounds=QWEN3_ROUNDS,
                     label="slice_qwen3", profile="zo_step_qwen3")


# ------------------------------------------------------------- options --
def route_losses(torch, dev, cfg, batch):
    """The logits and the LM loss of ``batch`` on ``cfg`` (random weights
    from SEED) on the kernel, online and dense (q-block-chunked) attention
    routes.  The launch counts are set to 0 once, before the three routes,
    and read after each.  Returns (losses, each route's max |logit - the
    kernel route's| over the kernel route's max |logit|, seconds, launches
    by route, launches of the three); the parameters are freed on
    return."""
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelCtx
    params = Model(cfg, device=dev).init(seed=SEED)
    out, gap, times, by_route = {}, {}, {}, {}
    ops.reset_launches()
    before = ops.launches()
    with torch.no_grad():
        for route, q_block in (("kernel", 0), ("online", 0),
                               ("dense", OPTIONS_Q_BLOCK)):
            model = Model(cfg, ModelCtx(attn_backend=route,
                                        attn_q_block=q_block), device=dev)
            t0 = time.perf_counter()
            logits = model.forward(params, batch)[0]
            out[route] = float(model.loss(params, batch))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times[route] = time.perf_counter() - t0
            now = ops.launches()
            by_route[route] = {k: now[k] - before[k] for k in now}
            before = now
            if route == "kernel":
                want, scale = logits, float(logits.abs().max())
            gap[route] = float((logits - want).abs().max()) / scale
            del logits
    return out, gap, times, by_route, before


def run_options(torch, dev, cfgs):
    """The other new options at full width, ``cfgs`` = (ChatGLM3-6B:
    partial RoPE, QKV bias, G 16, cut to CHATGLM_LAYERS layers;
    Phi-3.5-MoE: LayerNorm, 16 experts top-2, cut to PHI_LAYERS): one LM
    loss of
    OPTIONS_B x OPTIONS_S on the kernel, online and dense routes, within
    OPTIONS_ROUTE_REL; then ChatGLM3 behind the serving engine (the
    flash-decode kernel at G 16) with ``run_serve``'s checks, and every
    served token against the argmax of the teacher-forced training forward.
    Returns (launch counts: the kernel-route losses and the engine's run,
    the counts they imply)."""
    import numpy as np

    from repro_torch.models import Model

    cfg, phi = cfgs
    rng = np.random.default_rng(SEED + 3)
    counts = {name: 0 for name in KERNEL_SOURCES}
    expected = dict(counts)
    rows = {}
    for c in (cfg, phi):
        batch = {"tokens": rng.integers(0, c.vocab, (OPTIONS_B, OPTIONS_S))
                 .astype(np.int32)}
        losses, logit_gap, times, by_route, got = route_losses(
            torch, dev, c, batch)
        for name in counts:
            counts[name] += got[name]
        # the kernel route's forward and loss, one launch a layer each;
        # the online and dense routes launch nothing
        expected["flash_attention"] += 2 * c.n_layers
        ref_loss = losses["kernel"]
        gap = {r: abs(v - ref_loss) / abs(ref_loss)
               for r, v in losses.items()}
        rows[c.name] = dict(n_layers=c.n_layers, n_params=Model(
            c, device=dev).n_params, norm=c.norm, rope=c.rope_style,
            G=c.n_heads // c.n_kv_heads, head_dim=c.resolved_head_dim,
            losses=losses, rel_to_kernel=gap, logits_rel_to_kernel=logit_gap,
            launches_by_route=by_route, times_s=times)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"options: non-finite loss on {c.name}: {losses}")
        if by_route["kernel"]["flash_attention"] != 2 * c.n_layers or any(
                by_route[r][k] for r in ("online", "dense") for k in got):
            fail(f"options: {c.name}'s routes launched {by_route}")
        if max(gap.values()) > OPTIONS_ROUTE_REL:
            fail(f"options: {c.name}'s attention routes disagree: {losses}")
        if max(logit_gap.values()) > OPTIONS_LOGIT_REL:
            fail(f"options: {c.name}'s attention routes' logits disagree: "
                 f"{logit_gap} > {OPTIONS_LOGIT_REL}")
    emit("options.routes", B=OPTIONS_B, S=OPTIONS_S,
         dense_q_block=OPTIONS_Q_BLOCK, bound=OPTIONS_ROUTE_REL,
         logits_bound=OPTIONS_LOGIT_REL, **rows)

    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in CHATGLM_PROMPTS]
    S_max = max(CHATGLM_PROMPTS) + CHATGLM_NEW
    served = {}
    got, want = run_serve(torch, dev, cfg, prompts=prompts,
                          news=[CHATGLM_NEW] * len(prompts), S_max=S_max,
                          slots=len(prompts), route_reqs=range(len(prompts)),
                          naive_reqs=(), label="options.serve_chatglm3",
                          outs_out=served)
    for name in counts:
        counts[name] += got[name]
        expected[name] += want[name]

    # every served token is the argmax of the training forward fed the
    # prompt and the tokens before it (kernel route, teacher-forced)
    model, params = served["model"], served["params"]
    worst = 0.0
    with torch.no_grad():
        for p, o in zip(prompts, served["outs"]):
            toks = np.concatenate([p, o[:-1]]).astype(np.int32)[None]
            lg = model.forward(params, {"tokens": toks})[0][0, len(p) - 1:]
            t = torch.as_tensor(o, device=dev).long()
            top = lg.max(-1).values
            short = (top - lg.gather(-1, t[:, None])[:, 0]) / \
                lg.abs().amax(-1)
            worst = max(worst, float(short.max()))
    emit("options.teacher_forced", ok=worst <= SERVE_TIE_REL,
         worst_gap=worst, tie_bound=SERVE_TIE_REL,
         tokens=[len(o) for o in served["outs"]])
    if worst > SERVE_TIE_REL:
        fail(f"options: a served ChatGLM3 token is not the argmax of the "
             f"teacher-forced forward ({worst} > {SERVE_TIE_REL})")
    return counts, expected


# ------------------------------------------------------------- first order --
def run_first_order(torch, dev, cfg):
    """The backprop baseline on ``cfg``: Adam steps through
    ``make_train_step`` and one FedAvg round through ``fedavg_round``, on
    the task loss, every pass through the flash kernels; returns (launch
    counts over the run, the counts the run implies)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  make_task_fns, sample_dataset, subset)
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelCtx
    from repro_torch.train import fedavg_round, make_train_step
    from repro_torch.utils import tree_leaves

    on_card = dev.type == "cuda"
    phase_done, times, peaks, resident = phase_clock(torch, on_card)
    t0 = time.perf_counter()
    model = Model(cfg, ModelCtx(attn_backend="kernel"), device=dev)
    params = model.init(seed=SEED)
    spec = TaskSpec(vocab=512, seq_len=SEQ_LEN)
    loss, _, evaluate = make_task_fns(model, spec)
    train = sample_dataset(spec, 1024, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=N_CLIENTS,
                                alpha=0.5)
    per_client = [C.Client(k, subset(train, p), batch_size=FO_BATCH)
                  .next_batches(FO_LOCAL_STEPS) for k, p in enumerate(parts)]
    client_batches = {k: np.stack([b[k] for b in per_client])
                      for k in per_client[0]}      # [K, T, b, ...]
    adam_batches = [{k: v[i * FO_BATCH:(i + 1) * FO_BATCH]
                     for k, v in train.items()} for i in range(FO_ADAM_STEPS)]
    ev = sample_dataset(spec, EVAL_EXAMPLES, seed=2)

    def moved(new):
        return max(float((a - b).abs().max())
                   for a, b in zip(tree_leaves(new), tree_leaves(params)))
    phase_done("setup", t0)

    ops.reset_launches()  # the path starts here
    t0 = time.perf_counter()
    init, step = make_train_step(loss, "adam", lr=FO_LR, device=dev)
    state, p, adam_losses = init(params), params, []
    for b in adam_batches:
        p, state, lval = step(p, state, b)
        adam_losses.append(float(lval))
    adam_moved = moved(p)
    del state, p
    phase_done("adam", t0)
    t0 = time.perf_counter()
    avg = fedavg_round(loss, params, client_batches, FO_LR,
                       local_steps=FO_LOCAL_STEPS, device=dev)
    fedavg_moved = moved(avg)
    m = {k: float(v) for k, v in evaluate(avg, ev).items()}
    del avg
    phase_done("fedavg", t0)
    counts = ops.launches()  # the path ends here

    n_grads = FO_ADAM_STEPS + N_CLIENTS * FO_LOCAL_STEPS
    expected = {name: 0 for name in counts}
    expected.update({"flash_attention": cfg.n_layers * (n_grads + 1),
                     "flash_attention_bwd_dq": cfg.n_layers * n_grads,
                     "flash_attention_bwd_dkv": cfg.n_layers * n_grads})
    finite = bool(np.all(np.isfinite(adam_losses))
                  and all(np.isfinite(v) for v in m.values()))
    emit("first_order", model=cfg.name, batch=FO_BATCH, seq_len=SEQ_LEN,
         adam_steps=FO_ADAM_STEPS, adam_losses=adam_losses,
         adam_max_param_change=adam_moved, fedavg_clients=N_CLIENTS,
         fedavg_local_steps=FO_LOCAL_STEPS, fedavg_eval=m,
         fedavg_max_param_change=fedavg_moved, lr=FO_LR, finite=finite,
         launches=counts, expected_launches=expected, times_s=times,
         adam_step_s=times["adam"] / FO_ADAM_STEPS,
         fedavg_round_s=times["fedavg"], peak_gb=peaks, resident_gb=resident)
    if not finite:
        fail("non-finite loss in the first-order baseline")
    if not (adam_moved > 0 and fedavg_moved > 0):
        fail("the first-order steps left the parameters where they were")
    if on_card:
        state = init(params)
        profile_step(torch, "adam_step",
                     lambda: step(params, state, adam_batches[0]))
    return counts, expected


# ------------------------------------------------------------------- serve --
def timed_engine(torch, base):
    """The engine class with a synchronized host clock around each
    admission wave (prefill) and each decode burst: one sync per wave and
    per burst, none per token."""
    class Timed(base):
        prefill_s = decode_s = 0.0  # each engine's own sums

        def _admit(self):
            t0 = time.perf_counter()
            super()._admit()
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t0

        def _decode(self, n_steps, remaining, key):
            t0 = time.perf_counter()
            out = super()._decode(n_steps, remaining, key)
            torch.cuda.synchronize()
            self.decode_s += time.perf_counter() - t0
            return out
    return Timed


def teacher_forced(torch, model, params, prompt, toks, S_max):
    """Replay one request alone: prefill, then ``decode_step`` fed the
    engine's own tokens.  Returns (worst shortfall of each token's logit
    below the step's largest, over max |logit|; near-ties: steps where the
    token is within the bound but not the argmax)."""
    from repro_torch.serving.engine import _frontend_extra, _frontend_stub
    logits, cache = model.prefill(
        params, {"tokens": prompt[None],
                 **_frontend_stub(model.cfg, 1, model.device)},
        S_max=S_max + _frontend_extra(model.cfg))
    t = torch.as_tensor(toks, device=model.device).long()
    rows = []
    for i in range(len(toks)):
        lg = logits[0]
        rows.append(torch.stack([(lg.max() - lg[t[i]]) / lg.abs().max(),
                                 (lg.argmax() != t[i]).float()]))
        if i + 1 < len(toks):
            logits, cache = model.decode_step(params, t[i:i + 1].int(),
                                              cache)
    r = torch.stack(rows).cpu()
    return float(r[:, 0].max()), int(r[:, 1].sum())


def route_gap(torch, models, params, prompt, toks, S_max):
    """Largest |logit| difference between the decode routes of ``models``
    (kernel, ref), teacher-forced on the same tokens from one prefill, over
    the step's largest |logit|."""
    from repro_torch.serving.engine import _frontend_extra, _frontend_stub
    from repro_torch.utils import tree_map
    cfg = models[0].cfg
    logits, cache = models[0].prefill(
        params, {"tokens": prompt[None],
                 **_frontend_stub(cfg, 1, models[0].device)},
        S_max=S_max + _frontend_extra(cfg))
    caches = [cache] + [tree_map(torch.clone, cache) for _ in models[1:]]
    t = torch.as_tensor(toks, device=models[0].device).int()
    gaps = []
    for i in range(len(toks)):
        out = [m.decode_step(params, t[i:i + 1], c)[0]
               for m, c in zip(models, caches)]
        gaps.append((out[0] - out[1]).abs().max() / out[1].abs().max())
    return float(torch.stack(gaps).max())


def inactive_rows_kept(torch, model, params, cache) -> dict:
    """One decode step on ``cache`` (in place) with every other row
    inactive: {leaf path: whether the inactive rows of the leaf, and their
    positions, stayed bit-equal}."""
    from repro_torch.utils import tree_map
    B = int(cache["pos"].shape[0])
    active = torch.arange(B, device=model.device) % 2 == 0
    before = tree_map(torch.clone, cache)
    tok = torch.zeros((B,), dtype=torch.int32, device=model.device)
    model.decode_step(params, tok, cache, active=active)
    off = ~active
    kept = {"pos": bool(torch.equal(before["pos"][off], cache["pos"][off]))}
    for (name, a), (_, b) in zip(named_leaves(before["stack"]),
                                 named_leaves(cache["stack"])):
        kept[name] = bool(torch.equal(a[:, off], b[:, off]))
    return kept


def replay_matches_eager(torch, engine) -> dict:
    """One decode burst of ``engine``'s graph cache replayed against the
    same burst run eagerly (the entry's body) from the same state: {"toks",
    "logits", each cache leaf: bit-equal}.  The burst is the cache's
    longest captured one (every slot live for the whole burst where it is
    tailed); the engine's state is left as the eager burst leaves it."""
    from repro_torch.utils import tree_map
    from repro_torch.utils.tree import tree_leaves
    keys = [k for k, fn in engine.compile_cache._fns.items()
            if k[0] == "decode" and getattr(fn, "graph", None) is not None]
    if not keys:
        return {}
    key = max(keys)
    fn = engine.compile_cache._fns[key]
    n, tailed = key[1], key[2]
    dev = engine.device
    inputs = dict(
        remaining=torch.full((engine.max_slots,), n, dtype=torch.int32,
                             device=dev) if tailed else None,
        key=engine._key.clone() if engine.temperature > 0 else None)
    state = (tree_map(torch.clone, engine.cache), engine.last_logits.clone())
    toks = fn(**inputs).clone()  # the replay
    replayed = (tree_map(torch.clone, engine.cache),
                engine.last_logits.clone())
    for dst, src in zip(tree_leaves(engine.cache), tree_leaves(state[0])):
        dst.copy_(src)
    engine.last_logits.copy_(state[1])
    eager = fn.body(**inputs)
    same = {"toks": bool(torch.equal(toks, eager)),
            "logits": bool(torch.equal(replayed[1], engine.last_logits))}
    for (name, a), (_, b) in zip(named_leaves(replayed[0]),
                                 named_leaves(engine.cache)):
        same[name] = bool(torch.equal(a, b))
    return same


def serve_pass(engine, prompts, news) -> tuple:
    """The requests through ``engine`` (submitted in order, then run):
    (tokens, host seconds)."""
    for p, m in zip(prompts, news):
        engine.submit(p, max_new_tokens=m)
    t0 = time.perf_counter()
    outs = engine.run()
    return outs, time.perf_counter() - t0


def profiled_bursts(torch, label, graphed, eager, prompts, slots):
    """One decode burst under torch.profiler on the graph engine (its
    keys captured by an unprofiled run of the same traffic first, so the
    profiled burst is a replay) and on the eager one: fill every slot,
    a warm step (admission and a 32-token burst), a profiled 8-token
    burst.  Emits profile.{label}_decode_burst (graphs) and
    profile.{label}_decode_burst_eager."""
    for p in prompts[:slots]:
        graphed.submit(p[:64], max_new_tokens=40)
    graphed.run()
    for tag, engine in (("", graphed), ("_eager", eager)):
        for p in prompts[:slots]:
            engine.submit(p[:64], max_new_tokens=40)
        profile_step(torch, f"{label}_decode_burst{tag}", engine.step)
        engine.run()


def run_serve(torch, dev, cfg, *, prompts, news, S_max, slots, route_reqs,
              naive_reqs, label, outs_out=None, route_steps=None,
              profile=True):
    """Serving on ``cfg`` through the port's public API: the
    continuous-batching engine over ``prompts`` (greedy), its compile
    cache as CUDA graphs on the card, twice over (the second pass all
    hits), and the same requests on an eager twin (graphs off) first;
    then its checks: the tokens of both passes and the twin's equal,
    every token against the request replayed alone, the kernel and ref
    decode routes (over the first ``route_steps`` tokens, all when None),
    the naive engine, one decode step with every other row inactive that
    must leave those rows' cache leaves bit-equal, and on the card one
    burst replayed from the cache bit-equal to the same burst run eagerly.
    Returns (launch counts over the graph engine's two passes, the counts
    they imply); ``outs_out``, a dict, gets the model, its parameters,
    the engine and its tokens."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelCtx
    from repro_torch.models import layers as L
    from repro_torch.serving import ContinuousBatchingEngine, ServeEngine
    from repro_torch.serving.engine import _frontend_extra

    on_card = dev.type == "cuda"
    phase_done, times, peaks, resident = phase_clock(torch, on_card)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(seed=SEED)
    Engine = timed_engine(torch, ContinuousBatchingEngine) if on_card \
        else ContinuousBatchingEngine
    kw = dict(max_slots=slots, S_max=S_max, bucket=SERVE_BUCKET)
    eager = Engine(model, params, graphs=False, **kw)
    phase_done("setup", t0)

    # the eager twin first, so that each run's peak is its own
    t0 = time.perf_counter()
    eager_outs, _ = serve_pass(eager, prompts, news)
    eager_s = dict(prefill_s=getattr(eager, "prefill_s", None),
                   decode_s=getattr(eager, "decode_s", None))
    phase_done("eager", t0)
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    engine = Engine(model, params, **kw)

    ops.reset_launches()  # the path starts here
    t0 = time.perf_counter()
    outs, _ = serve_pass(engine, prompts, news)
    phase_done("engine", t0)
    first = dict(engine.stats, capture_s=engine.capture_s,
                 prefill_s=getattr(engine, "prefill_s", None),
                 decode_s=getattr(engine, "decode_s", None))
    t0 = time.perf_counter()
    again, _ = serve_pass(engine, prompts, news)
    phase_done("engine_again", t0)
    counts = ops.launches()  # the path ends here
    stats = engine.stats
    second = {k: (stats[k] - first[k]) for k in
              ("decode_steps", "compile_hits", "compile_misses")}
    if on_card:
        second.update(prefill_s=engine.prefill_s - first["prefill_s"],
                      decode_s=engine.decode_s - first["decode_s"])
    n_tok = sum(len(o) for o in outs)
    kernel_decode = L.resolve_decode_backend("auto", cfg) == "kernel"
    # a wave's prefill runs over its padded tokens behind any patch prefix
    extra = _frontend_extra(cfg)
    long_waves = sum(1 for _, S_pad in engine.prefill_waves
                     if L.resolve_attn_backend("auto", cfg, S=S_pad + extra)
                     == "kernel")
    n_attn = n_mixers(cfg, "attn", "local_attn")
    expected = {name: 0 for name in counts}
    expected["flash_attention"] = n_attn * long_waves
    expected["flash_decode"] = (n_attn * stats["decode_steps"]
                                if kernel_decode else 0)
    # the selective scan once per Mamba layer per wave (no grad: kernel)
    expected["mamba_scan"] = n_mixers(cfg, "mamba") * len(
        engine.prefill_waves)
    same_passes = all(np.array_equal(a, b) and np.array_equal(a, c)
                      for a, b, c in zip(outs, again, eager_outs))

    t0 = time.perf_counter()
    worst, ties = 0.0, 0
    for p, o in zip(prompts, outs):
        w, n = teacher_forced(torch, model, params, p, o, len(p) + len(o))
        worst, ties = max(worst, w), ties + n
    phase_done("check_single", t0)
    t0 = time.perf_counter()
    routes = (model, Model(cfg, ModelCtx(decode_backend="ref"), device=dev))
    gap = max(route_gap(torch, routes, params, prompts[i],
                        outs[i][:route_steps],
                        len(prompts[i]) + len(outs[i])) for i in route_reqs)
    phase_done("check_routes", t0)
    t0 = time.perf_counter()
    replay = replay_matches_eager(torch, engine) if on_card else None
    kept = inactive_rows_kept(torch, model, params, engine.cache)
    phase_done("check_inactive", t0)
    naive_worst, naive_ties, naive_same = 0.0, 0, None
    if naive_reqs:
        t0 = time.perf_counter()
        naive = ServeEngine(model, params, max_batch=slots,
                            bucket=SERVE_BUCKET)
        for i in naive_reqs:
            naive.submit(prompts[i], max_new_tokens=news[i])
        nouts = naive.flush()
        same = [bool(np.array_equal(a, outs[i]))
                for a, i in zip(nouts, naive_reqs)]
        naive_same = sum(same)
        # tokens equal to the engine's passed the check above already
        for a, i, eq in zip(nouts, naive_reqs, same):
            if not eq:
                w, n = teacher_forced(torch, model, params, prompts[i], a,
                                      len(prompts[i]) + len(a))
                naive_worst, naive_ties = max(naive_worst, w), naive_ties + n
        phase_done("check_naive", t0)

    engine_s = times["engine"]
    capture = first["capture_s"]
    step_ms = None
    if on_card:
        step_ms = dict(
            eager=eager_s["decode_s"] * 1e3 / eager.stats["decode_steps"],
            graphs_first_pass=(first["decode_s"] - capture["decode"]) * 1e3
            / first["decode_steps"],
            graphs_second_pass=second["decode_s"] * 1e3
            / second["decode_steps"])
    emit(label, model=cfg.name, n_layers=cfg.n_layers, n_params=model.n_params,
         requests=len(prompts), slots=slots, S_max=S_max,
         prompt_tokens=int(sum(len(p) for p in prompts)),
         generated_tokens=n_tok, decode_steps=first["decode_steps"],
         prefill_waves=engine.prefill_waves[:len(engine.prefill_waves) // 2],
         prefill_s=first["prefill_s"], decode_s=first["decode_s"],
         capture_s=capture, engine_s=engine_s,
         tokens_per_s=n_tok / engine_s, ttft_mean_s=first["ttft_mean_s"],
         compile_hits=first["compile_hits"],
         compile_misses=first["compile_misses"],
         compile_entries=engine.compile_cache.n_entries,
         second_pass=dict(second, engine_s=times["engine_again"],
                          tokens_per_s=n_tok / times["engine_again"]),
         eager=dict(eager_s, engine_s=times["eager"],
                    tokens_per_s=n_tok / times["eager"],
                    peak_gb=peaks.get("eager")),
         decode_step_ms=step_ms, passes_and_eager_same_tokens=same_passes,
         replay_bit_equal_to_eager=replay,
         inactive_rows_bit_equal=kept,
         single_worst_gap=worst, single_near_ties=ties,
         tie_bound=SERVE_TIE_REL, route_gap=gap, route_bound=SERVE_ROUTE_REL,
         route_requests=list(route_reqs), naive_requests=list(naive_reqs),
         naive_same_tokens=naive_same, naive_worst_gap=naive_worst,
         naive_near_ties=naive_ties, launches=counts,
         expected_launches=expected, times_s=times, peak_gb=peaks,
         resident_gb=resident)
    if len(outs) != len(prompts) or any(len(o) != m
                                        for o, m in zip(outs, news)):
        fail(f"{label}: the engine returned the wrong number of tokens")
    if not same_passes:
        fail(f"{label}: the graph engine's two passes and the eager "
             f"engine gave different tokens")
    if second["compile_misses"]:
        fail(f"{label}: the second pass of the same requests missed the "
             f"compile cache {second['compile_misses']} times")
    if on_card and (not replay or not all(replay.values())):
        fail(f"{label}: a replayed burst differs from the eager burst: "
             f"{replay}")
    if worst > SERVE_TIE_REL or naive_worst > SERVE_TIE_REL:
        fail(f"{label}: a token is not the argmax of the request replayed "
             f"alone (engine {worst}, naive {naive_worst} > {SERVE_TIE_REL})")
    if gap > SERVE_ROUTE_REL:
        fail(f"{label}: kernel and ref decode routes differ by {gap}")
    if not all(kept.values()):
        fail(f"{label}: an inactive row's cache changed in a decode step: "
             f"{[k for k, v in kept.items() if not v]}")
    if on_card and kernel_decode and profile:
        profiled_bursts(torch, label, engine, eager, prompts, slots)
    if outs_out is not None:
        outs_out.update(model=model, params=params, outs=outs, engine=engine)
    return counts, expected


def serve_traffic(vocab):
    """SERVE_REQUESTS prompts of uniform length in SERVE_PROMPT_LENS and
    budgets in SERVE_NEW, from numpy's default_rng(0)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    lens = rng.integers(SERVE_PROMPT_LENS[0], SERVE_PROMPT_LENS[1] + 1,
                        SERVE_REQUESTS)
    news = [int(n) for n in rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1,
                                         SERVE_REQUESTS)]
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]
    return prompts, news


def run_serve_llama(torch, dev, cfg):
    prompts, news = serve_traffic(cfg.vocab)
    return run_serve(torch, dev, cfg, prompts=prompts, news=news,
                     S_max=SERVE_S_MAX, slots=SERVE_SLOTS,
                     route_reqs=range(4), naive_reqs=range(8), label="serve")


def run_serve_gemma(torch, dev, cfg):
    """Gemma-2-2b at full width, 2 periods (4 layers): a prompt longer than
    the 4096-position window fills the rolling local cache; the prefill wave
    and the decode kernel run with softcap at head_dim 256, G 2."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in GEMMA_PROMPTS]
    return run_serve(torch, dev, cfg, prompts=prompts,
                     news=[GEMMA_NEW] * len(prompts), S_max=GEMMA_S_MAX,
                     slots=len(prompts), route_reqs=range(len(prompts)),
                     naive_reqs=(), label="serve_gemma")


def run_grad_gemma(torch, dev, cfg):
    """Gemma-2-2b at full width, 2 periods (4 layers), under autograd: the
    sensitivity mask and one pre-training gradient of a 1 x
    GEMMA_GRAD_TOKENS batch, past the 4096-position window, on the auto
    attention route (the flash kernels, backward at head_dim 256 with
    softcap and, on the local layers, the window), held against the dense
    route: per leaf within GRAD_REL_BOUND, the masks overlapping by
    MASK_OVERLAP_MIN.  Returns (launch counts of the kernel-route passes,
    the counts they imply)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.core.gradip import grad_tree
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelCtx
    from repro_torch.models.layers import resolve_attn_backend

    on_card = dev.type == "cuda"
    phase_done, times, peaks, resident = phase_clock(torch, on_card)
    t0 = time.perf_counter()
    route = resolve_attn_backend("auto", cfg, S=GEMMA_GRAD_TOKENS,
                                 differentiable=True)
    if route != "kernel":
        fail(f"grad_gemma: the auto route under autograd is {route!r}")
    model = Model(cfg, ModelCtx(attn_backend="auto"), device=dev)
    dense = Model(cfg, ModelCtx(attn_backend="dense"), device=dev)
    params = model.init(seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    batch = {"tokens": rng.integers(0, cfg.vocab, (1, GEMMA_GRAD_TOKENS))
             .astype(np.int32)}
    phase_done("setup", t0)

    ops.reset_launches()  # the main path starts here
    t0 = time.perf_counter()
    space = C.sensitivity_mask(lambda p, b: model.loss(p, b), params,
                               [batch], density=DENSITY, device=dev)
    phase_done("mask_kernel", t0)
    t0 = time.perf_counter()
    gk = grad_tree(lambda p, b: model.loss(p, b), params, batch)
    phase_done("grad_kernel", t0)
    counts = ops.launches()  # the main path ends here

    t0 = time.perf_counter()
    dense_space = C.sensitivity_mask(lambda p, b: dense.loss(p, b), params,
                                     [batch], density=DENSITY, device=dev)
    overlap = mask_overlap(torch, space, dense_space, params)
    del dense_space
    phase_done("mask_dense", t0)
    t0 = time.perf_counter()
    gd = grad_tree(lambda p, b: dense.loss(p, b), params, batch)
    grad_rel = {
        name: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        for (name, a), (_, b) in zip(named_leaves(gk), named_leaves(gd))}
    finite = all(bool(torch.isfinite(g).all()) for _, g in named_leaves(gk))
    del gk, gd
    phase_done("grad_dense", t0)

    n_grads = 2  # the mask's batch and the gradient's
    expected = {name: 0 for name in counts}
    expected.update({"flash_attention": cfg.n_layers * n_grads,
                     "flash_attention_bwd_dq": cfg.n_layers * n_grads,
                     "flash_attention_bwd_dkv": cfg.n_layers * n_grads})
    emit("grad_gemma", model=cfg.name, n_layers=cfg.n_layers,
         tokens=GEMMA_GRAD_TOKENS, window=cfg.sliding_window,
         softcap=cfg.attn_softcap, head_dim=cfg.resolved_head_dim,
         route=route, mask_coords=space.n, launches=counts,
         expected_launches=expected, finite=finite,
         mask_overlap_kernel_vs_dense=overlap,
         mask_overlap_min=MASK_OVERLAP_MIN,
         grad_rel_kernel_vs_dense=grad_rel,
         grad_rel_max=max(grad_rel.values()), grad_rel_bound=GRAD_REL_BOUND,
         times_s=times, peak_gb=peaks, resident_gb=resident)
    if not finite:
        fail("non-finite gradient in grad_gemma")
    if max(grad_rel.values()) > GRAD_REL_BOUND:
        fail(f"grad_gemma: kernel-route gradient differs from the dense "
             f"route's: {grad_rel} > {GRAD_REL_BOUND}")
    if overlap < MASK_OVERLAP_MIN:
        fail(f"grad_gemma: kernel-route mask overlaps the dense-route mask "
             f"by {overlap}")
    return counts, expected


# ------------------------------------------------------------------ hybrid --
def run_slice_jamba(torch, dev, cfg):
    """MEERKAT-VP on the hybrid ``cfg`` through the port's public API: one
    model whose forwards take the selective-scan kernel and whose
    differentiated passes take the scan route (``mamba_mode`` auto), the ZO
    rounds on the route ``zo_backend="auto"`` picks (the tree route at this
    size).  Returns (launch counts over the run, the counts the run
    implies)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import FLConfig
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  make_task_fns, pretrain_batches,
                                  sample_dataset, subset)
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelCtx

    on_card = dev.type == "cuda"
    phase_done, times, peaks, resident = phase_clock(torch, on_card)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(seed=SEED)
    spec = TaskSpec(vocab=512, seq_len=SEQ_LEN)
    loss, _, evaluate = make_task_fns(model, spec)
    train = sample_dataset(spec, 1024, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=N_CLIENTS,
                                alpha=0.5)
    clients = [C.Client(k, subset(train, p), batch_size=JAMBA_CLIENT_BATCH)
               for k, p in enumerate(parts)]
    ev = sample_dataset(spec, JAMBA_EVAL, seed=2)
    pre = pretrain_batches(spec, n_batches=JAMBA_PRETRAIN_BATCHES,
                           batch_size=JAMBA_PRETRAIN_BATCH)
    phase_done("setup", t0)

    ops.reset_launches()  # the main path starts here
    t0 = time.perf_counter()
    m0 = {k: float(v) for k, v in evaluate(params, ev).items()}
    phase_done("eval_before", t0)
    t0 = time.perf_counter()
    space = C.sensitivity_mask(lambda p, b: model.loss(p, b), params, pre,
                               density=DENSITY, device=dev)
    phase_done("mask", t0)
    fl = FLConfig(n_clients=N_CLIENTS, local_steps=1, eps=1e-3,
                  density=DENSITY, zo_backend="auto", vp_init_steps=1,
                  vp_later_steps=1, vp_sigma_relative=True, seed=SEED)
    server = C.FederatedZO(loss, params, space, fl, clients,
                           eval_fn=evaluate, device=dev)
    t0 = time.perf_counter()
    gp = C.pretrain_gradient_vec(lambda p, b: model.loss(p, b), params,
                                 space, pre)
    phase_done("pretrain_gradient", t0)
    t0 = time.perf_counter()
    results, flagged, trajs = server.calibrate_vp(gp, T_cali=JAMBA_T_CALI)
    phase_done("calibrate_vp", t0)
    t0 = time.perf_counter()
    server.run(JAMBA_ROUNDS, gp_vec=gp)
    phase_done("rounds", t0)
    t0 = time.perf_counter()
    m1 = {k: float(v) for k, v in evaluate(server.params, ev).items()}
    phase_done("eval_after", t0)

    # one client's own trajectory against the server's replay of its scalar
    t0 = time.perf_counter()
    run = C.make_local_run(loss, space, fl.eps, fl.lr, backend="auto")
    keys = C.round_keys(fl.seed, server.round, 1)
    batches = {k: torch.as_tensor(v, device=dev)
               for k, v in clients[0].next_batches(1).items()}
    delta, gs = run(server.params, keys, batches,
                    torch.zeros(space.n, device=dev))
    rec = C.reconstruct_delta(space, keys, gs.cpu().numpy(), fl.lr)
    rel = float((delta - rec).abs().max() / rec.abs().max())
    replay_ok = bool(torch.allclose(delta, rec, rtol=1e-6,
                                    atol=1e-6 * float(rec.abs().max())))
    phase_done("replay_check", t0)
    counts = ops.launches()  # the main path ends here

    # the kernel route's logits against the scan route's on the eval batch
    t0 = time.perf_counter()
    scan = Model(cfg, ModelCtx(mamba_mode="scan"), device=dev)
    with torch.no_grad():
        lk, _ = model.forward(params, {"tokens": ev["tokens"]})
        ls, _ = scan.forward(params, {"tokens": ev["tokens"]})
        route_rel = float((lk - ls).abs().max() / ls.abs().max())
        logit_max = float(ls.abs().max())
    del lk, ls
    phase_done("route_check", t0)

    n_mamba = cfg.n_periods * sum(m == "mamba" for m, _ in cfg.layer_pattern)
    n_attn = cfg.n_layers - n_mamba
    n_steps = N_CLIENTS * JAMBA_T_CALI + JAMBA_ROUNDS * N_CLIENTS + 1
    n_forwards = 2 * n_steps + 2  # two per ZO step, plus the two evals
    n_grads = 2 * JAMBA_PRETRAIN_BATCHES  # mask and pre-training gradient
    expected = {name: 0 for name in counts}
    expected.update({
        "gradip_flat": N_CLIENTS * JAMBA_T_CALI + JAMBA_ROUNDS * N_CLIENTS,
        "flash_attention": n_attn * (n_forwards + n_grads),
        "flash_attention_bwd_dq": n_attn * n_grads,
        "flash_attention_bwd_dkv": n_attn * n_grads,
        "mamba_scan": n_mamba * n_forwards})
    scalars = [g for h in server.gradip_log.values() for g in h]
    finite = (all(np.isfinite(v) for v in (*m0.values(), *m1.values()))
              and all(np.all(np.isfinite(t)) for t in trajs)
              and all(np.all(np.isfinite(g)) for g in scalars)
              and bool(torch.isfinite(gp).all())
              and bool(torch.isfinite(gs).all()))
    emit("slice_jamba", model=cfg.name, n_layers=cfg.n_layers,
         layer_pattern=cfg.layer_pattern, n_params=model.n_params,
         mask_coords=space.n, clients=N_CLIENTS,
         client_batch=JAMBA_CLIENT_BATCH, seq_len=SEQ_LEN,
         T_cali=JAMBA_T_CALI, rounds=JAMBA_ROUNDS, flagged=flagged,
         eval_before=m0, eval_after=m1, up_bytes=server.comm.up_bytes,
         down_bytes=server.comm.down_bytes, launches=counts,
         expected_launches=expected, replay_max_rel_err=rel,
         replay_ok=replay_ok, finite=finite, route_rel=route_rel,
         route_bound=MAMBA_ROUTE_REL, logit_max=logit_max, times_s=times,
         round_s=times["rounds"] / JAMBA_ROUNDS,
         zo_step_s=times["rounds"] / (JAMBA_ROUNDS * N_CLIENTS),
         peak_gb=peaks, resident_gb=resident,
         max_memory_allocated_gb=max(peaks.values(), default=None))
    if not finite:
        fail("non-finite loss, scalar or GradIP in the Jamba slice")
    if not replay_ok:
        fail(f"Jamba: client delta and server replay differ (max rel {rel})")
    if route_rel > MAMBA_ROUTE_REL:
        fail(f"Jamba: kernel-route logits differ from the scan route's by "
             f"{route_rel} of max |logit|")
    if on_card:
        profile_step(torch, "zo_step_jamba", lambda: run(
            server.params, keys, batches, torch.zeros(space.n, device=dev)))
    return counts, expected


def moe_loop_ref(torch, x, p, mcfg):
    """Plain reference of the MoE FFN's capacity dispatch, independent of
    ``moe.moe_dense_ref``'s one-hot cumsum: (token, slot) pairs in token
    order, each taking its expert's next free place until the expert holds
    C = ceil(T * k / E * capacity_factor); then each expert's kept rows
    through its (silu-gated) FFN, gate-weighted.  Returns (y [B, S, D],
    kept [E], C)."""
    B, S, D = x.shape
    E, k, T = mcfg.n_experts, mcfg.top_k, B * S
    assert "sw1" not in p  # Jamba's MoE has no shared expert
    C = max(1, math.ceil(T * k / E * mcfg.capacity_factor))
    x2d = x.reshape(T, D)
    probs = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    places = [[] for _ in range(E)]
    for t, experts in enumerate(idx.tolist()):
        for j, e in enumerate(experts):
            if len(places[e]) < C:
                places[e].append((t, j))
    y = torch.zeros_like(x2d)
    for e, pairs in enumerate(places):
        if not pairs:
            continue
        t, j = torch.tensor(pairs, device=x.device).T
        h = torch.nn.functional.silu(x2d[t] @ p["w1"][e])
        if "w3" in p:
            h = h * (x2d[t] @ p["w3"][e])
        y.index_add_(0, t, gate[t, j][:, None] * (h @ p["w2"][e]))
    return y.reshape(B, S, D), [len(pl) for pl in places], C


def run_jamba_moe(torch, dev, cfg):
    """One forward and one LM loss of the (Mamba, MoE) layer ``cfg`` at
    batch JAMBA_MOE_BATCH x SEQ_LEN on the default routes, finite; then the
    MoE FFN on the layer's real input against :func:`moe_loop_ref`, at the
    configured capacity and at MOE_TIGHT_CAPACITY, where pairs must be
    dropped.  Returns (launch counts over the forward and the loss, the
    counts they imply)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_map

    on_card = dev.type == "cuda"
    phase_done, times, peaks, resident = phase_clock(torch, on_card)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(seed=SEED)
    tokens = torch.randint(0, cfg.vocab, (JAMBA_MOE_BATCH, SEQ_LEN),
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED), device=dev)
    phase_done("setup", t0)

    ops.reset_launches()  # the path starts here
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, aux = model.forward(params, {"tokens": tokens})
        finite = bool(torch.isfinite(logits).all()) and \
            bool(torch.isfinite(aux))
        del logits
        phase_done("forward", t0)
        t0 = time.perf_counter()
        lm = float(model.loss(params, {"tokens": tokens}))
        phase_done("lm_loss", t0)
        counts = ops.launches()  # the path ends here
        # the MoE FFN's input in that forward, through both dispatches
        t0 = time.perf_counter()
        lp = tree_map(lambda a: a[0], params["stack"])["p0"]
        x = T.embed_input(params, {"tokens": tokens}, cfg)
        x = T._mixer_fwd(x, lp, "mamba", cfg, model.ctx, None)
        h = L.rmsnorm(x, lp["norm2"]["scale"], cfg.norm_eps)
        dispatch = {}
        for cf in (cfg.moe.capacity_factor, MOE_TIGHT_CAPACITY):
            mcfg = dataclasses.replace(cfg.moe, capacity_factor=cf)
            y, _ = MOE.moe_dense_ref(h, lp, mcfg, cfg.act)
            ry, kept, cap = moe_loop_ref(torch, h, lp, mcfg)
            dispatch[cf] = dict(
                capacity=cap, kept=kept,
                dropped=JAMBA_MOE_BATCH * SEQ_LEN * mcfg.top_k - sum(kept),
                rel_err=float((y - ry).abs().max() / ry.abs().max()))
            del y, ry
        phase_done("dispatch_check", t0)
    expected = {name: 0 for name in counts}
    expected["mamba_scan"] = 2 * cfg.n_layers  # the forward and the loss
    emit("jamba_moe", model=cfg.name, layer_pattern=cfg.layer_pattern,
         n_params=model.n_params, batch=JAMBA_MOE_BATCH, seq_len=SEQ_LEN,
         n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
         dispatch=dispatch, tol=MOE_LOOP_REL, aux=float(aux), lm_loss=lm,
         finite=finite and math.isfinite(lm), launches=counts,
         expected_launches=expected, times_s=times, peak_gb=peaks,
         resident_gb=resident)
    if not (finite and math.isfinite(lm)):
        fail("jamba_moe: non-finite logits, load-balance loss or LM loss")
    for cf, d in dispatch.items():
        if d["rel_err"] > MOE_LOOP_REL:
            fail(f"jamba_moe: the MoE FFN at capacity factor {cf} differs "
                 f"from the per-token loop by {d['rel_err']} of its largest "
                 f"entry")
    if dispatch[MOE_TIGHT_CAPACITY]["dropped"] == 0:
        fail(f"jamba_moe: capacity factor {MOE_TIGHT_CAPACITY} dropped no "
             f"pair, so the dispatch check did not test capacity")
    return counts, expected



# ----------------------------------------------------- hybrid serving ------
def check_serving_shapes(torch, ops, ref, dev):
    """Rows 3, 7 and 8 at the serving shapes of phases serve_jamba and
    families, each against its plain version, timed (CUDA events) beside
    its plain version, its library call and its bound: the flash forward
    at Jamba's first prefill wave (G 8, head_dim 128, ragged lengths) and at
    Whisper's decoder wave (G 1, head_dim 64), flash decode at their served
    caches, the selective scan at a [2, 1536, 16384] prefill with dt zeroed
    past each row's length (its final state the decode state).  Returns
    {kernel: {tag: row}}."""
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {"flash_attention": {}, "flash_decode": {}, "mamba_scan": {}}
    shapes = {"jamba_serve": (8, 8, 128, JAMBA_SERVE_PROMPTS[:4],
                              JAMBA_SERVE_S_MAX),
              "whisper": (12, 1, 64, WHISPER_PROMPTS, WHISPER_S_MAX)}
    for tag, (KV, G, dh, lens, S_cache) in shapes.items():
        S = -(-max(lens) // SERVE_BUCKET) * SERVE_BUCKET
        out["flash_attention"][tag] = flash_forward_row(
            torch, ops, ref, dev, gen, tag, len(lens), S, KV, G, dh,
            list(lens))
        # decode at the served cache: every row at its last step
        out["flash_decode"][tag] = flash_decode_row(
            torch, ops, ref, dev, gen, tag, S_cache, KV, G, dh,
            [n + FAMILY_NEW for n in lens])

    # the selective scan at a serving prefill: dt zeroed past each length
    B, S, E, N = 2, 1536, 16384, 16
    lens = torch.tensor(JAMBA_SERVE_PROMPTS[4:6], device=dev)
    dt, Bi, Ci, x, A = mamba_inputs(torch, dev, gen, B, S, E, N)
    dt = dt * (torch.arange(S, device=dev)[None, :] < lens[:, None])[..., None]
    args = (dt, Bi, Ci, x, A)
    y, h = ops.mamba_scan(*args)
    ry, rh = ref.mamba_scan_ref(*args)
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in ((y, ry), (h, rh))]
    err = max(float((y - ry).abs().max()), float((h - rh).abs().max()))
    del y, h, ry, rh
    if max(errs) > MAMBA_SCAN_REL:
        fail(f"mamba_scan differs from plain at the serving prefill: {errs}")
    n_bytes = 4.0 * (3 * B * S * E + 2 * B * S * N + E * N + B * E * N)
    # past a row's length dt is 0: no decay to exponentiate
    n_exp = float(int(lens.sum()) * E * N)
    mem_ms = n_bytes / peak("hbm_bw") * 1e3
    exp_ms = n_exp / EXP_PER_S * 1e3
    out["mamba_scan"]["jamba_serve"] = dict(
        shape=f"dt, x [{B},{S},{E}] f32, N {N}, lengths {lens.tolist()}",
        max_abs_err=err, max_rel_err=errs,
        ms=timed(lambda: ops.mamba_scan(*args), 10),
        plain_ms=timed(lambda: ref.mamba_scan_ref(*args), 2),
        library_ms=None, bound_ms=max(mem_ms, exp_ms),
        bound_by="bytes" if mem_ms >= exp_ms else "operations")
    del args, dt, Bi, Ci, x, A
    emit("kernels.serving_shapes", ok=True, **out)
    return out


def run_serve_jamba(torch, dev, cfg):
    """Jamba-1.5-Large at full width, one period of (attention, dense) and
    (Mamba, MoE): the engine over JAMBA_SERVE_PROMPTS with run_serve's
    checks (the decode routes over JAMBA_ROUTE_STEPS tokens), then the
    first wave's prefill Mamba cache on the kernel route against the scan
    route, and the decode step's time beside its weight-streaming floor
    (moe_dense_ref reads every expert's weights at every step)."""
    import numpy as np

    from repro_torch.models import Model, ModelCtx

    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in JAMBA_SERVE_PROMPTS]
    served = {}
    counts, expected = run_serve(
        torch, dev, cfg, prompts=prompts, news=list(JAMBA_SERVE_NEW),
        S_max=JAMBA_SERVE_S_MAX, slots=JAMBA_SERVE_SLOTS, route_reqs=(3,),
        naive_reqs=(), label="serve_jamba", outs_out=served,
        route_steps=JAMBA_ROUTE_STEPS)
    params, engine = served["params"], served["engine"]
    wave = prompts[:JAMBA_SERVE_SLOTS]
    S_pad = -(-max(map(len, wave)) // SERVE_BUCKET) * SERVE_BUCKET
    toks = np.zeros((len(wave), S_pad), np.int32)
    for i, p in enumerate(wave):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in wave], np.int32)
    t0 = time.perf_counter()
    leaves = {}
    with torch.no_grad():
        for mode in ("kernel", "scan"):
            m = Model(cfg, ModelCtx(mamba_mode=mode), device=dev)
            _, cache = m.prefill(params, {"tokens": toks}, S_max=S_pad,
                                 lengths=lens)
            leaves[mode] = {k: cache["stack"]["p1"][k] for k in
                            ("conv", "state")}
            del cache
    rel = {k: float((leaves["kernel"][k] - leaves["scan"][k]).abs().max()
                    / leaves["scan"][k].abs().max())
           for k in ("conv", "state")}
    del leaves
    weights = 4.0 * (served["model"].n_params - cfg.vocab * cfg.d_model)
    # the graph engine's two passes, capture seconds taken out
    step_ms = (engine.decode_s - engine.capture_s["decode"]) * 1e3 \
        / max(1, engine.stats["decode_steps"]) if dev.type == "cuda" else None
    emit("serve_jamba.checks", mamba_prefill_rel=rel, tol=MAMBA_STATE_REL,
         wave_lengths=lens.tolist(), wave_S_pad=S_pad,
         routes_s=time.perf_counter() - t0, decode_step_ms=step_ms,
         decode_weight_gb=weights / 1e9,
         decode_step_floor_ms=weights / peak("hbm_bw") * 1e3)
    if max(rel.values()) > MAMBA_STATE_REL:
        fail(f"serve_jamba: the prefill's Mamba cache differs between the "
             f"kernel and scan routes: {rel}")
    return counts, expected


def family_forward_check(torch, dev, cfg, tag):
    """Prefill FAMILY_FWD_S - 1 tokens of 2 rows (frontend embeddings from
    concrete_inputs, a seeded generator), then decode the last: the prefill
    and decode logits against the training forward's last two, of its max
    |logit| (the JAX package's test_prefill_decode_matches_forward)."""
    from repro_torch.models import Model, concrete_inputs
    from repro_torch.serving.engine import _frontend_extra
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(seed=SEED)
    S = FAMILY_FWD_S
    batch = concrete_inputs(cfg, 2, S, torch.Generator(device=dev)
                            .manual_seed(SEED), device=dev)
    with torch.no_grad():
        full, _ = model.forward(params, batch)
        full = full[:, S - 2:].clone()
        pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
        lp, cache = model.prefill(params, pre,
                                  S_max=S + 4 + _frontend_extra(cfg))
        ld, cache = model.decode_step(params, batch["tokens"][:, S - 1],
                                      cache)
    scale = float(full.abs().max())
    rel = [float((a - full[:, i]).abs().max()) / scale
           for i, a in enumerate((lp, ld))]
    emit(f"families.forward_{tag}", model=cfg.name, n_layers=cfg.n_layers,
         n_params=model.n_params, S=S, prefill_rel=rel[0], decode_rel=rel[1],
         bound=FAMILY_FWD_REL, finite=bool(torch.isfinite(full).all()),
         seconds=time.perf_counter() - t0)
    del model, params, full, cache
    if max(rel) > FAMILY_FWD_REL or not all(map(math.isfinite, rel)):
        fail(f"families: {cfg.name}'s prefill/decode logits differ from the "
             f"training forward's: {rel} > {FAMILY_FWD_REL}")


def run_families(torch, dev, cfgs):
    """xLSTM-350m at full size: FAMILY_ROUNDS MEERKAT rounds of N_CLIENTS
    Dirichlet clients at T=1 with GradIP on the slice's task (no VP
    calibration, run_slice), then serving; Whisper-small at full size and
    Pixtral-12b at full width (PIXTRAL_LAYERS layers) served.  Each model
    first passes family_forward_check, then the engine with run_serve's
    checks (zero frontend stubs, as the JAX package's engines).  Returns
    the launch counts summed over the rounds and the engines' runs, and
    the counts they imply."""
    import numpy as np
    xlstm, whisper, pixtral = cfgs
    counts, expected = run_slice(torch, dev, xlstm, t_cali=0,
                                 rounds=FAMILY_ROUNDS,
                                 label="families.xlstm_rounds", profile=None)
    rng = np.random.default_rng(SEED + 3)
    for tag, cfg, lens, S_max in (("xlstm", xlstm, XLSTM_PROMPTS,
                                   XLSTM_S_MAX),
                                  ("whisper", whisper, WHISPER_PROMPTS,
                                   WHISPER_S_MAX),
                                  ("pixtral", pixtral, PIXTRAL_PROMPTS,
                                   PIXTRAL_S_MAX)):
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        family_forward_check(torch, dev, cfg, tag)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                   for n in lens]
        got, want = run_serve(torch, dev, cfg, prompts=prompts,
                              news=[FAMILY_NEW] * len(prompts), S_max=S_max,
                              slots=FAMILY_SLOTS, route_reqs=range(2),
                              naive_reqs=(), label=f"families.serve_{tag}",
                              profile=False)
        for name in counts:
            counts[name] += got[name]
            expected[name] += want[name]
    return counts, expected


# ---------------------------------------------------------------- examples --
def load_example(name: str):
    """``examples/<name>_torch.py`` as a module."""
    import importlib
    path = str(ROOT / "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(f"{name}_torch")


def example_replay(torch, out) -> float:
    """One quickstart client's own T=1 step on the kernel route against the
    server's replay of its scalar: the largest relative difference, or
    raises past rtol 1e-6 (the slice's replay check)."""
    import repro_torch.core as C
    server, space, fl = out["server"], out["space"], out["server"].fl
    dev = server.device
    run = C.make_local_run(out["loss"], space, fl.eps, fl.lr,
                           backend="kernel")
    keys = C.round_keys(fl.seed, server.round, 1)
    batches = {k: torch.as_tensor(v, device=dev)
               for k, v in server.clients[0].next_batches(1).items()}
    delta, gs = run(server.params, keys, batches,
                    torch.zeros(space.n, device=dev))
    rec = C.reconstruct_delta(space, keys, gs.cpu().numpy(), fl.lr)
    if not torch.allclose(delta, rec, rtol=1e-6,
                          atol=1e-6 * float(rec.abs().max())):
        fail("examples.quickstart: client delta and server replay differ")
    return float((delta - rec).abs().max() / rec.abs().max())


def run_examples(torch, dev, _cfg=None):
    """The five ``examples/*_torch.py`` in process on the card, at CI's
    smoke sizes (EXAMPLE_ARGV), each with its own check, launch counts and
    seconds; a row its path reaches (EXAMPLE_ROWS) launched no time fails.
    Returns the summed counts and those the runs imply: rows 1, 2 and 4
    counted from the steps (example_zo_launches), the others as launched
    (each example's line holds its own)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.utils.tree import tree_leaves
    device = "cpu" if dev.type == "cpu" else None
    total = {name: 0 for name in KERNEL_SOURCES}
    total_want = dict(total)
    ckpt = ROOT / "build" / "examples" / "e2e_ckpt_torch.msgpack"
    for name, argv in EXAMPLE_ARGV:
        mod = load_example(name)
        args = mod.parser().parse_args(
            list(argv) + (["--ckpt", str(ckpt)] if name == "train_e2e"
                          else []))
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ops.reset_launches()  # the example's path starts here
        t0 = time.perf_counter()
        out = mod.run(args, device=device)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launches()  # and ends here
        check = {}
        if name == "quickstart":
            steps = args.clients * args.rounds  # T=1
            accs = [out["acc_before"], out["acc_after"]] + \
                [h["acc"] for h in out["history"]]
            check = dict(up_bytes=out["up_bytes"], up_bytes_want=4 * steps,
                         replay_max_rel_err=example_replay(torch, out),
                         accuracy=accs, finite=bool(np.isfinite(accs).all()))
            ok = check["finite"] and out["up_bytes"] == 4 * steps
        elif name == "train_e2e":
            accs = [out["acc_before"], out["acc_final"]] + \
                [h["acc"] for h in out["history"]]
            check = dict(model=out["n_params"], flagged=out["flagged"],
                         accuracy=accs, finite=bool(np.isfinite(accs).all()),
                         ckpt_bytes=ckpt.stat().st_size)
            ok = check["finite"] and all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(out["restored"]), tree_leaves(out["params"])))
            ckpt.unlink()
        elif name == "vpcs_demo":
            check = dict(flagged=out["flagged"], finite=all(
                bool(np.isfinite(t).all()) for t in out["trajectories"]))
            ok = check["finite"]
        elif name == "serve_batch":
            same = {}
            for arch, got in out.items():
                engine = got["engine"]
                for p in got["prompts"]:
                    engine.submit(p, max_new_tokens=args.max_new)
                again = engine.run()
                same[arch] = [a.tolist() for a in again] == \
                    [a.tolist() for a in got["outs"]]
                check[arch] = dict(seconds=got["seconds"],
                                   stats=engine.stats,
                                   capture_s=engine.capture_s,
                                   second_pass_equal=same[arch])
            ok = all(same.values())
        else:  # mesh_round
            check = dict(bit_params=out["bit_params"],
                         bit_gradip=out["bit_gradip"],
                         up_equal=out["up_equal"],
                         n_devices=out["sharded"]["n_devices"])
            ok = out["bit_params"] and out["bit_gradip"] and out["up_equal"]
        missing = [r for r in EXAMPLE_ROWS[name] if not counts[r]]
        # rows 1, 2 and 4 launch once a ZO step and once a GradIP step;
        # the attention, decode and scan rows as the examples' shapes route
        want = dict(counts)
        if dev.type == "cuda":
            want.update(example_zo_launches(name, args, out))
        emit(f"examples.{name}", argv=list(argv), seconds=seconds,
             launches=counts, expected_launches=want,
             rows_required=list(EXAMPLE_ROWS[name]), rows_missing=missing,
             check=check, ok=bool(ok))
        if not ok:
            fail(f"examples.{name}: its check failed: {check}")
        if dev.type == "cuda" and missing:
            fail(f"examples.{name}: rows {missing} launched no time")
        for k in total:
            total[k] += counts[k]
            total_want[k] += want[k]
        del out
    return total, total_want


def example_zo_launches(name, args, out) -> dict:
    """Rows 1, 2 and 4's launches that an example's run implies: one
    dual perturb and one fused update a ZO step, one GradIP reduction a
    step of a trajectory."""
    if name == "quickstart":
        steps, gradip = args.clients * args.rounds, 0
    elif name == "train_e2e":
        cali = args.clients * 100   # FLConfig.vp_calibration_steps
        flagged = len(out["flagged"])
        steps = cali + args.rounds * (
            args.T * (args.clients - flagged) + flagged)
        gradip = cali
    elif name == "vpcs_demo":
        steps = gradip = len(out["trajectories"]) * args.steps
    elif name == "mesh_round":
        # unsharded, then the same rounds on the mesh, GradIP every step
        steps = gradip = 2 * args.rounds * load_example(name).K * args.T
    else:
        return {}
    return {"zo_dual_perturb_flat": steps, "zo_fused_update_flat": steps,
            "gradip_flat": gradip}


def run_hlo_tools_line() -> None:
    """``python -m repro_torch.launch.hlo_tools`` (HLO_TOOLS_ARGV: JAX's own
    docstring example, depth 1 on the fake 16x16 group, no device): its op
    totals and top ops, with its seconds."""
    from repro_torch.launch import hlo_tools
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        got = hlo_tools.main(list(HLO_TOOLS_ARGV))
    emit("hlo_tools", argv=list(HLO_TOOLS_ARGV), step=got["step"],
         records=got["records"], seconds=time.perf_counter() - t0,
         totals_mb={k: v / 1e6 for k, v in sorted(
             got["totals"].items(), key=lambda kv: -kv[1])},
         top=[{"mb": b / 1e6, "op": op, "line": line}
              for b, op, line in got["top"]])
    if not got["top"] or "all-gather" not in got["totals"]:
        fail(f"hlo_tools: no ops counted: {got['totals']}")


# ---------------------------------------------------------------- autotune --
def use_table(table) -> None:
    """Point the port's autotune lookups at ``table`` (a directory)."""
    from repro_torch.kernels import autotune
    os.environ["REPRO_TORCH_AUTOTUNE_DIR"] = str(table)
    autotune.clear_cache()


def autotune_keys(cfgs) -> list:
    """(op, S, head_dim, G, kv_heads, batch) the autotune phase tunes: the
    forward at the ZO steps of Llama-3.2-1B and Qwen3-4B, at ChatGLM3-6B's
    loss and at Gemma-2-2b's prefill wave; the gradient at Llama's mask
    and Adam steps and at Gemma's 4352-token batch."""
    llama, qwen3, chatglm3, gemma = cfgs

    def lay(cfg):
        return (cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads,
                cfg.n_kv_heads)

    S_gemma = -(-max(GEMMA_PROMPTS) // SERVE_BUCKET) * SERVE_BUCKET
    return [("fwd", SEQ_LEN, *lay(llama), CLIENT_BATCH),
            ("grad", SEQ_LEN, *lay(llama), PRETRAIN_BATCH),
            ("fwd", SEQ_LEN, *lay(qwen3), CLIENT_BATCH),
            ("fwd", OPTIONS_S, *lay(chatglm3), OPTIONS_B),
            ("fwd", S_gemma, *lay(gemma), len(GEMMA_PROMPTS)),
            ("grad", GEMMA_GRAD_TOKENS, *lay(gemma), 1)]


def autotune_cli(keys, *extra) -> tuple:
    """``python -m repro_torch.kernels.autotune`` over ``keys`` into
    TUNED_TABLE, in this process: (exit codes, printed lines)."""
    from repro_torch.kernels import autotune
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rcs = [autotune.main([
            "--ops", op, "--s-list", str(S), "--head-dim", str(hd), "--g",
            str(G), "--kv-heads", str(kv), "--batch", str(B), "--reps",
            str(AUTOTUNE_REPS), "--table-dir", str(TUNED_TABLE), *extra])
            for op, S, hd, G, kv, B in keys]
    return rcs, buf.getvalue().splitlines()


def run_autotune(torch, dev, cfgs):
    """kernels/autotune.py on the card: tune ``fwd`` and ``grad`` at the
    full-width keys of the models the other phases drive into a table of
    its own (TUNED_TABLE), print each entry, and check that a second CLI
    run over the same keys is all cached (``--require-cached`` exits 0);
    then one Llama-3.2-1B ZO step (CLIENT_BATCH x SEQ_LEN, the auto
    attention route) and the forward at each tuned ``fwd`` key's shape
    (Gemma-2-2b's [2, 4208, 8, 256] prefill wave with its lengths and
    softcap), each with the default tiling (the empty table) beside the
    tuned table: counted, held against each other (the step's g) and the
    plain version (the forwards), then timed in turns.  Returns (launch
    counts over the counted runs, the counts they imply)."""
    import repro_torch.core as C
    from repro_torch.data import TaskSpec, make_task_fns, sample_dataset
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.models import Model
    from repro_torch.models import layers as L

    llama, qwen3, chatglm3, gemma = cfgs
    keys = autotune_keys(cfgs)
    shutil.rmtree(TUNED_TABLE, ignore_errors=True)
    t0 = time.perf_counter()
    rcs, lines = autotune_cli(keys)
    tune_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rcs_again, lines_again = autotune_cli(keys, "--require-cached")
    cached_s = time.perf_counter() - t0
    table = autotune.load_table(str(TUNED_TABLE))
    for key in sorted(table):
        emit("autotune.entry", key=key, **table[key])
    emit("autotune.cli", keys=[list(k) for k in keys], exit_codes=rcs,
         require_cached_exit_codes=rcs_again, tune_s=tune_s,
         cached_s=cached_s, lines=lines, require_cached_lines=lines_again)
    want = {autotune.key_for(op, S, hd, G) for op, S, hd, G, _, _ in keys}
    if any(rcs) or any(rcs_again) or set(table) != want:
        fail(f"autotune: exit codes {rcs}, then with --require-cached "
             f"{rcs_again}, entries {sorted(table)} for keys {sorted(want)}")

    # the Llama ZO step and each tuned forward on both tables
    sync = torch.cuda.synchronize
    model = Model(llama, device=dev)
    params = model.init(seed=SEED)
    spec = TaskSpec(vocab=512, seq_len=SEQ_LEN)
    loss, _, _ = make_task_fns(model, spec)
    space = C.random_mask(params, DENSITY, seed=SEED)
    run = C.make_local_run(loss, space, 1e-3, 1e-3, backend="kernel")
    step_keys = C.round_keys(SEED, 0, 1)
    client = C.Client(0, sample_dataset(spec, CLIENT_BATCH, seed=1),
                      batch_size=CLIENT_BATCH)
    batches = {k: torch.as_tensor(v, device=dev)
               for k, v in client.next_batches(1).items()}
    zeros = torch.zeros(space.n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    attn = {}
    for (op, S, hd, G, KV, B), cfg in zip(keys, (llama, None, qwen3,
                                                 chatglm3, gemma, None)):
        if op != "fwd":
            continue
        q, k, v = _attn(torch, dev, gen, B, S, KV, G, hd, torch.float32)
        lens = GEMMA_PROMPTS if cfg is gemma else (S,) * B
        L_ = torch.tensor(lens, device=dev, dtype=torch.int32)
        kw = dict(window=0, softcap=cfg.attn_softcap)
        attn[cfg.name] = dict(
            args=(q, k, v, L_), kw=kw, want=ref.flash_attention_ref(
                q, k, v, L_, causal=True, **kw),
            shape=f"q [{B},{S},{KV * G},{hd}] f32, G={G}"
                  + ("" if cfg is not gemma else
                     f", lengths {list(lens)}, softcap {cfg.attn_softcap}"))
    tables = (("default", EMPTY_TABLE), ("tuned", TUNED_TABLE))
    n_attn = n_mixers(llama, "attn", "local_attn")
    expected = {name: 0 for name in ops.launches()}
    routes, gs = {}, {}
    ops.reset_launches()  # the path starts here
    for tag, tdir in tables:
        use_table(tdir)
        routes[tag] = L.resolve_attn_backend("auto", llama, S=SEQ_LEN)
        _, g = run(params, step_keys, batches, zeros)
        gs[tag] = float(g[0])
        for name, a in attn.items():
            q = a["args"][0]
            a.setdefault("tiling", {})[tag] = list(ops.fwd_tiling(
                q.shape[1], q.shape[3], q.shape[2] // a["args"][1].shape[2]))
            o, lse = ops.flash_attention(*a["args"], return_lse=True,
                                         **a["kw"])
            a.setdefault("max_abs_err", {})[tag] = max(
                float((o - a["want"][0]).abs().max()),
                float((lse - a["want"][1]).abs().max()))
        for name in ("zo_dual_perturb_flat", "zo_fused_update_flat"):
            expected[name] += 1
        expected["flash_attention"] += len(attn) + (
            2 * n_attn if routes[tag] == "kernel" else 0)
    sync()
    counts = ops.launches()  # the path ends here

    # in turns: default, tuned, tuned, default
    step_s = {tag: [] for tag, _ in tables}
    for _ in range(AUTOTUNE_TURNS):
        for tag, tdir in tables + tables[::-1]:
            use_table(tdir)
            sync()
            t = time.perf_counter()
            run(params, step_keys, batches, zeros)
            sync()
            step_s[tag].append(time.perf_counter() - t)
            for a in attn.values():
                a.setdefault("ms_turns", {}).setdefault(tag, []).append(
                    timed(lambda: ops.flash_attention(*a["args"],
                                                      **a["kw"]), 5))
    use_table(EMPTY_TABLE)
    forwards = {name: dict(shape=a["shape"], tiling=a["tiling"],
                           max_abs_err=a["max_abs_err"], tol=1e-4,
                           ms={t: statistics.median(v)
                               for t, v in a["ms_turns"].items()},
                           ms_turns=a["ms_turns"])
                for name, a in attn.items()}
    emit("autotune", platform=autotune.platform_key(), entries=len(table),
         routes=routes,
         zo_step=dict(shape=f"{llama.name}, {CLIENT_BATCH} x {SEQ_LEN}",
                      g=gs, g_rel_diff=abs(gs["default"] - gs["tuned"])
                      / max(abs(gs["default"]), 1e-30),
                      seconds={t: statistics.median(v)
                               for t, v in step_s.items()},
                      seconds_turns=step_s),
         forwards=forwards, launches=counts, expected_launches=expected)
    worst = max(max(f["max_abs_err"].values()) for f in forwards.values())
    if worst > 1e-4:
        fail(f"autotune: a tuned forward differs from plain: {forwards}")
    if not all(map(math.isfinite, gs.values())):
        fail(f"autotune: a non-finite ZO scalar {gs}")
    del model, params, space, attn
    return counts, expected


# ---------------------------------------------------------------- analysis --
def plan_cases(n_flat: int, n_mask: int):
    """(plan function, shape) of every kernel at the shapes of the registry
    (TINY at d_model 256, S 320) and of the earlier phases."""
    from repro_torch.kernels import plans as P
    cases = [(P.zo_update, dict(n=n_flat, bf16=False, has_m=False, vec=True,
                                update=u)) for u in (False, True)]
    cases += [(P.zo_update, dict(n=1023, bf16=True, has_m=True, vec=v,
                                 update=True)) for v in (False, True)]
    cases += [(P.gradip_reduce, dict(n=n_mask, vec=True)),
              (P.gradip_reduce, dict(n=777, vec=False))]
    attn = [dict(B=16, S=SEQ_LEN, KVH=8, G=4, dh=64),      # Llama slice
            dict(B=4, S=SEQ_LEN, KVH=8, G=8, dh=128),      # Jamba
            dict(B=2, S=320, KVH=2, G=2, dh=64),           # the registry
            dict(B=4, S=320, KVH=2, G=2, dh=64),           # stacked pair
            dict(B=2 * CLIENT_BATCH, S=SEQ_LEN, KVH=8, G=4,
                 dh=64)]                                   # phase stack
    cases += [(P.flash_attn_fwd, dict(**a, bf16=False)) for a in attn]
    cases += [(P.flash_attn_fwd, dict(B=2, S=4208, KVH=4, G=2, dh=256,
                                      bf16=False)),        # Gemma prefill
              (P.flash_attn_fwd, dict(B=1, S=130, KVH=2, G=4, dh=128,
                                      bf16=True))]
    # the forward's tilings: 32-key tiles with (f32) and without (bf16) the
    # k, v lo planes, 16-key tiles at 256, one query a block at G 64
    cases += [(P.flash_attn_fwd, dict(B=2, S=200, KVH=2, G=G, dh=dh,
                                      bf16=b))
              for G, dh, b in ((64, 64, False), (64, 256, True),
                               (3, 128, False), (8, 64, True))]
    # every tiling of the forward and the backward, f32 and bf16
    cases += [(P.flash_attn_fwd, dict(B=2, S=300, KVH=2, G=2, dh=dh, bf16=b,
                                      tiling=t))
              for dh, ts in P.FLASH_FWD_TILINGS.items() for t in ts
              for b in (False, True)]
    cases += [(P.flash_attn_bwd, dict(B=2, S=300, KVH=2, G=2, dh=dh, bf16=b,
                                      dkv=d, tiling=t))
              for dh, ts in P.FLASH_BWD_TILINGS.items() for t in ts
              for b in (False, True) for d in (False, True)]
    # fused_update's chunks: below, at and above one, packed and not
    ch = P.zo_update_chunk(True)
    cases += [(P.zo_update, dict(n=n, bf16=b, has_m=m, vec=v, update=True))
              for n, b, m, v in ((ch - 1, False, False, True),
                                 (ch, True, True, True),
                                 (ch + 4, False, True, True),
                                 (ch + 1, True, False, False))]
    cases += [(P.flash_attn_bwd, dict(**a, bf16=False, dkv=d))
              for a in attn for d in (False, True)]
    cases += [(P.flash_attn_bwd, dict(B=1, S=GEMMA_GRAD_TOKENS, KVH=4, G=2,
                                      dh=256, bf16=b, dkv=d))
              for b in (False, True) for d in (False, True)]  # grad_gemma
    # decode: clusters of 8 (serving), 16 (Gemma), 2, 3 and 1 (S = 0)
    cases += [(P.flash_decode, dict(B=SERVE_SLOTS, S=SERVE_S_MAX, KVH=8, G=4,
                                    dh=64, bf16=False)),
              (P.flash_decode, dict(B=2, S=4096, KVH=4, G=2, dh=256,
                                    bf16=False)),
              (P.flash_decode, dict(B=2, S=GEMMA_S_MAX, KVH=4, G=2, dh=256,
                                    bf16=True)),
              (P.flash_decode, dict(B=2, S=320, KVH=2, G=2, dh=64,
                                    bf16=False)),
              (P.flash_decode, dict(B=5, S=700, KVH=2, G=16, dh=128,
                                    bf16=True)),
              (P.flash_decode, dict(B=2, S=0, KVH=8, G=4, dh=64,
                                    bf16=False))]
    cases += [(P.mamba_scan, dict(B=4, S=SEQ_LEN, E=16384, N=16)),
              (P.mamba_scan, dict(B=2 * STACK_JAMBA_CLIENTS, S=SEQ_LEN,
                                  E=16384, N=16)),         # phase stack
              (P.mamba_scan, dict(B=2, S=300, E=256, N=8)),
              (P.mamba_scan, dict(B=1, S=2048, E=129, N=16))]
    cases += [(P.fixture_double, dict(rows=r, cols=c, block_rows=r,
                                      aligned=True))
              for r, c in (FIXTURE_GOOD, FIXTURE_BAD)]
    cases += [(P.fixture_double, dict(rows=128, cols=c, block_rows=32,
                                      aligned=a))
              for c, a in ((128, False), (130, True))]
    return cases


def check_plans(torch, dev, n_flat: int, n_mask: int):
    """Every kernel's plan (kernels/plans.py) against the library's own
    ``*_plan`` query (cudaFuncGetAttributes and the launcher's grid and
    dynamic bytes)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import plans as P
    lib = build.load()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bad = []
    cases = plan_cases(n_flat, n_mask)
    for fn, shape in cases:
        extra = {"n_sms": n_sms} if fn is P.zo_update else {}
        want = [l.numbers() for l in fn(**shape, **extra)]
        got = [l.numbers() for l in P.query(lib, fn, **shape)]
        if want != got:
            bad.append(dict(plan=fn.__name__, shape=shape, python=want,
                            library=got))
    emit("analysis.plans", ok=not bad, cases=len(cases),
         kernels=sorted({fn.__name__ for fn, _ in cases}), mismatches=bad)
    return bad


def _sync_warnings(torch, fn, args):
    """The synchronizing operations torch.cuda.set_sync_debug_mode("warn")
    reports over one call of fn(*args)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [str(w.message)[:160] for w in caught
            if "synchroniz" in str(w.message)]


def _record_counted(torch, ops, AC, built, dev):
    """Artifacts of one built program: the repeat calls, then the recorded
    call with the launch counts from zero; returns (artifacts, counts, the
    counts its kernel records imply: one launch per record that did not
    raise, on the card; none on the CPU, where the plain versions run)."""
    art = AC.Artifacts(built, dev)
    if built.meta.get("runtime", True):
        art.repeat()
    ops.reset_launches()
    trace = art.trace()
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    counts = ops.launches()
    expected = {name: 0 for name in counts}
    for r in trace.records:
        if on_card and r.kind == "kernel" and not r.raised:
            expected[r.name.split(":", 1)[1]] += 1
    return art, counts, expected


def folded_times(vmapped, folded, two) -> dict:
    """CUDA-event ms and host ms a call (:func:`timed`) of the vmapped call,
    of the folded launch it makes, called directly on the folded operands,
    and of a launch per member: the vmapped call's excess over the folded
    launch is the host's (``torch.func.vmap`` and the rule)."""
    out = {}
    for name, fn in (("vmapped", vmapped), ("folded", folded),
                     ("two_launches", two)):
        out[f"ms_{name}"], out[f"enqueue_ms_{name}"] = timed(fn, 10,
                                                             host=True)
    return out


def check_folded_launches(torch, ops, dev):
    """Rows 3 and 8 under ``torch.func.vmap`` over a stacked pair: one
    folded launch each, bit-equal to a launch per member, with the ms of
    each way (:func:`folded_times`).  Row 3 at Llama-3.2-1B's burst shape, row 8 at
    Jamba's (dt, x [4, 512, 16384], N 16) with a per-member A, as the
    stacked forward hands them over."""
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    q, k, v = (torch.randn(2, CLIENT_BATCH, SEQ_LEN, h, 64, generator=gen,
                           device=dev) for h in (32, 8, 8))
    folded = torch.func.vmap(lambda q, k, v: ops.flash_attention(
        q, k, v, return_lse=True))
    ops.reset_launches()
    got = folded(q, k, v)
    n_folded = ops.launches()["flash_attention"]
    want = [ops.flash_attention(q[i], k[i], v[i], return_lse=True)
            for i in range(2)]
    n_two = ops.launches()["flash_attention"] - n_folded
    equal = all(torch.equal(got[j][i], want[i][j]) for i in range(2)
                for j in range(2))
    qf, kf, vf = (t.flatten(0, 1) for t in (q, k, v))
    out["flash_attention"] = dict(
        shape=f"q [2 x {CLIENT_BATCH}, {SEQ_LEN}, 32, 64] f32",
        bit_equal=equal, launches_folded=n_folded, launches_per_member=n_two,
        **folded_times(
            lambda: folded(q, k, v), lambda: ops.flash_attention(qf, kf, vf),
            lambda: [ops.flash_attention(q[i], k[i], v[i])
                     for i in range(2)]))
    del q, k, v, qf, kf, vf, got, want
    B, E, N = STACK_JAMBA_CLIENTS, 16384, 16
    dt, x = (torch.nn.functional.softplus(torch.randn(
        2, B, SEQ_LEN, E, generator=gen, device=dev)) * 0.1,
        torch.randn(2, B, SEQ_LEN, E, generator=gen, device=dev))
    Bm, Cm = (torch.randn(2, B, SEQ_LEN, N, generator=gen, device=dev)
              for _ in range(2))
    A = -torch.exp(torch.randn(2, E, N, generator=gen, device=dev) * 0.5)
    scan = torch.func.vmap(ops.mamba_scan)
    ops.reset_launches()
    got = scan(dt, Bm, Cm, x, A)
    n_folded = ops.launches()["mamba_scan"]
    want = [ops.mamba_scan(dt[i], Bm[i], Cm[i], x[i], A[i])
            for i in range(2)]
    n_two = ops.launches()["mamba_scan"] - n_folded
    equal = all(torch.equal(got[j][i], want[i][j]) for i in range(2)
                for j in range(2))
    fold = [t.flatten(0, 1) for t in (dt, Bm, Cm, x)]
    out["mamba_scan"] = dict(
        shape=f"dt, x [2 x {B}, {SEQ_LEN}, {E}] f32, N {N}, A per member",
        bit_equal=equal, launches_folded=n_folded, launches_per_member=n_two,
        **folded_times(
            lambda: scan(dt, Bm, Cm, x, A),
            lambda: ops.mamba_scan(*fold, A),
            lambda: [ops.mamba_scan(dt[i], Bm[i], Cm[i], x[i], A[i])
                     for i in range(2)]))
    ops.reset_launches()
    emit("stack.folded", **out)
    # (the kernels' rows are each computed alone; on the CPU, a rehearsal,
    # the plain versions' GEMMs may block a batch of 2B otherwise)
    bad = [name for name, r in out.items()
           if not (r["bit_equal"] and r["launches_folded"] == 1
                   and r["launches_per_member"] == 2)]
    if bad and on_card:
        fail(f"stack: folded launches {bad}: {out}")


def stack_compare(torch, dev, tag, model, space, params, tokens, *,
                  n_clients: int, stack, backend=None, cut=None):
    """One model's train burst, the stacked route (``stack``: True, or None
    where the auto rule is to pick it) against ``stack_forwards=False``:
    the burst's first pair through both (``fl_step.pair_losses``: per
    example within STACK_LOSS_REL), then the burst each way twice (the
    second timed), its scalars and parameters within the bounds the gaps
    imply; ``cut`` says how the model was cut to fit.  Returns (the line's
    numbers, launch counts over the calls, the counts they imply)."""
    from repro_torch.core import fl_step as FS
    from repro_torch.core import prng
    from repro_torch.core.dispatch import get_backing
    from repro_torch.kernels import ops

    def loss(p, b):
        return model.loss(p, b, per_example=True)

    on_card = dev.type == "cuda"
    cuda = torch.cuda
    sync = cuda.synchronize if on_card else (lambda: None)
    cfg = model.cfg
    n_attn = n_mixers(cfg, "attn")
    n_mamba = n_mixers(cfg, "mamba")
    n_steps = int(tokens.shape[0])
    backing = get_backing(space, params)
    key = prng.key(1)
    keys = prng.split(key, n_steps)
    auto = FS.stacks_forwards(None, backing)
    if stack is None and not auto:
        fail(f"stack {tag}: the auto rule does not stack at "
             f"{backing.n_flat} flat parameters")
    total = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected = dict(total)

    def count(n1=0, n2=0, n3=0, n8=0):
        for name, c in ops.launches().items():
            total[name] += c
        for name, c in (("zo_dual_perturb_flat", n1),
                        ("zo_fused_update_flat", n2),
                        ("flash_attention", n3), ("mamba_scan", n8)):
            expected[name] += c if on_card else 0
        ops.reset_launches()

    # the first pair, both ways, on the same w, z and rows
    ops.reset_launches()
    with torch.no_grad():
        w_flat = backing.flatten(params)
        z_flat = backing.expand(space.sample_z(keys[0]))
        b0 = {"tokens": tokens[0]}
        seq = FS.pair_losses(loss, backing, w_flat, z_flat, b0, STACK_EPS,
                             stack=False)
        stk = FS.pair_losses(loss, backing, w_flat, z_flat, b0, STACK_EPS,
                             stack=True)
    del w_flat, z_flat
    sync()
    count(2, 0, 3 * n_attn, 3 * n_mamba)
    loss_rel = max(float(((a - b).abs() / b.abs()).max())
                   for a, b in zip(stk, seq))
    gap = ((stk[0] - seq[0]).abs() + (stk[1] - seq[1]).abs())
    g_bound = gap.reshape(n_clients, -1).mean(-1) / (2 * STACK_EPS)
    z_max = [float(space.sample_z(k).abs().max()) for k in keys]
    del stk, seq

    runs = {}
    for label, st in (("stacked", stack), ("sequential", False)):
        loop = FS.make_fl_train_loop(
            loss, space, eps=STACK_EPS, lr=STACK_LR, n_clients=n_clients,
            n_steps=n_steps, backend=backend, stack_forwards=st)
        per = 1 if label == "stacked" else 2
        for rep in range(2):
            gc.collect()
            sync()
            if on_card:
                cuda.reset_peak_memory_stats()
            before = cuda.memory_allocated() if on_card else 0
            t0 = time.perf_counter()
            p, gs, met = loop(params, key, {"tokens": tokens})
            sync()
            secs = time.perf_counter() - t0
            row3 = ops.launches()["flash_attention"]
            count(n_steps, n_steps, per * n_steps * n_attn,
                  per * n_steps * n_mamba)
            if rep == 0:
                peak = cuda.max_memory_allocated() if on_card else None
                runs[label] = dict(
                    gs=gs, loss=float(met["loss"]),
                    coords=space.slice(p).float(),
                    peak_gb=peak and peak / 1e9,
                    rise_gb=peak and (peak - before) / 1e9,
                    row3_per_step=(row3 / n_steps if on_card
                                   else per * n_attn))
            else:
                runs[label]["ms_per_step"] = secs * 1e3 / n_steps
            del p, gs, met
    a, b = runs["stacked"], runs["sequential"]
    dg = (a["gs"] - b["gs"]).abs()                   # [steps, K]
    g_first_ok = bool((dg[0] <= g_bound * (1 + 1e-3)
                       + 1e-6 * b["gs"][0].abs()).all())
    step_dg = (a["gs"].mean(1) - b["gs"].mean(1)).abs().tolist()
    w_max = float(b["coords"].abs().max())
    p_bound = sum(STACK_LR * d * zm + w_max * 2.0 ** -23
                  for d, zm in zip(step_dg, z_max))
    p_gap = float((a["coords"] - b["coords"]).abs().max())
    finite = bool(torch.isfinite(a["gs"]).all()
                  and torch.isfinite(b["gs"]).all())
    line = dict(
        model=cfg.name, cut=cut, n_params=backing.n_flat, auto_stacks=auto,
        stack_forwards=stack, steps=n_steps, clients=n_clients,
        rows=int(tokens.shape[1]), seq_len=int(tokens.shape[2]),
        attn_layers=n_attn, mamba_layers=n_mamba,
        first_pair_loss_rel=loss_rel, loss_rel_bound=STACK_LOSS_REL,
        first_step_g_gap=float(dg[0].max()),
        first_step_g_bound=float(g_bound.max()),
        g_gap_per_step=step_dg, param_gap=p_gap, param_bound=p_bound,
        row3_per_step={k: r["row3_per_step"] for k, r in runs.items()},
        ms_per_step={k: r["ms_per_step"] for k, r in runs.items()},
        peak_gb={k: r["peak_gb"] for k, r in runs.items()},
        rise_gb={k: r["rise_gb"] for k, r in runs.items()},
        burst_loss={k: r["loss"] for k, r in runs.items()}, finite=finite)
    emit(f"stack.{tag}", **line)
    problems = []
    if not finite:
        problems.append("non-finite scalars")
    if loss_rel > STACK_LOSS_REL:
        problems.append(f"per-example losses {loss_rel}")
    if not g_first_ok:
        problems.append("first-step scalars past the loss gaps' bound")
    if p_gap > p_bound:
        problems.append(f"parameters {p_gap} > {p_bound}")
    if a["row3_per_step"] != n_attn or b["row3_per_step"] != 2 * n_attn:
        problems.append(f"row-3 launches a step {line['row3_per_step']}")
    if problems:
        fail(f"stack {tag}: {problems}")
    return line, total, expected


def run_stack_drills(torch, dev):
    """``tools/kill_recover_torch.py``'s drill (each run a subprocess on
    ``dev``'s type, the card), STACK_DRILLS' two flag sets side by side:
    each victim SIGKILLed in round 2, each survivor's final checkpoint
    bit-equal to its reference."""
    import importlib.util
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    spec = importlib.util.spec_from_file_location(
        "kill_recover_torch", ROOT / "tools" / "kill_recover_torch.py")
    KR = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(KR)
    (ROOT / "build").mkdir(exist_ok=True)

    def one(flags):
        a = KR.parser().parse_args(["--rounds", "4", "--kill-at", "2",
                                    "--device", dev.type, *flags])
        work = tempfile.mkdtemp(prefix="drill_", dir=ROOT / "build")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            checks = KR.drill(a, work, timeout=300)
        shutil.rmtree(work, ignore_errors=True)
        return dict(flags=" ".join(flags) or "plain", ok=KR.passed(checks),
                    seconds=time.perf_counter() - t0, checks=checks)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(STACK_DRILLS)) as pool:
        rows = list(pool.map(one, STACK_DRILLS))
    emit("stack.drill", seconds=time.perf_counter() - t0, drills=rows)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"stack: the kill-and-recover drill failed: {bad}")


def run_stack(torch, dev, cfgs):
    """Phase stack (module docstring).  Returns (launch counts of its train
    bursts, the counts they imply)."""
    import numpy as np

    from repro_torch.core import random_mask
    from repro_torch.kernels import ops
    from repro_torch.models import Model

    tiny, llama, jamba = cfgs
    check_folded_launches(torch, ops, dev)
    total, expected = {}, {}

    def add(counts, exp):
        for k in counts:
            total[k] = total.get(k, 0) + counts[k]
            expected[k] = expected.get(k, 0) + exp[k]

    def tokens_for(cfg, steps, rows, seq):
        rng = np.random.default_rng(SEED)
        return torch.as_tensor(rng.integers(
            0, cfg.vocab, size=(steps, rows, seq), dtype=np.int32),
            device=dev)

    jamba_cut = (f"the first {jamba.n_layers} of the slice_jamba cut's 4 "
                 f"layers at full width: the flat route holds some five f32 "
                 f"copies of the parameters (98 GB at 4.9 B)")
    for tag, cfg, n_cl, rows, steps, stack, backend, cut in (
            ("tiny", tiny, STACK_TINY_CLIENTS, STACK_TINY_BATCH,
             STACK_TINY_STEPS, None, None, "d_model 256, vocab 256"),
            ("llama", llama, AN_CLIENTS, AN_BATCH, AN_STEPS, True, None,
             None),
            ("jamba", jamba, STACK_JAMBA_CLIENTS, 1, AN_STEPS, True,
             "kernel", jamba_cut)):
        t0 = time.perf_counter()
        model = Model(cfg, device=dev)
        params = model.init(seed=SEED)
        space = random_mask(params, density=DENSITY, seed=3, balanced=False)
        seq = STACK_TINY_S if tag == "tiny" else SEQ_LEN
        tokens = tokens_for(cfg, steps, n_cl * rows, seq)
        setup_s = time.perf_counter() - t0
        _, counts, exp = stack_compare(torch, dev, tag, model, space,
                                       params, tokens, n_clients=n_cl,
                                       stack=stack, backend=backend, cut=cut)
        add(counts, exp)
        emit(f"stack.{tag}.done", setup_s=setup_s,
             seconds=time.perf_counter() - t0)
        del model, params, space, tokens
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    run_stack_drills(torch, dev)
    return total, expected


def run_analysis_phase(torch, dev, cfg):
    """Phase 10 (module docstring).  Returns (launch counts summed over its
    counted calls, the counts they imply)."""
    from repro_torch.analysis import core as AC
    from repro_torch.analysis import rules as AR
    from repro_torch.analysis.fixtures import FIXTURES
    from repro_torch.analysis.registry import HOT_PATHS
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import process_group
    from repro_torch.models.init import param_count

    on_card = dev.type == "cuda"
    problems = []
    total = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    total_expected = dict(total)

    def add(counts, expected, what):
        if counts != expected:
            problems.append(f"{what}: launches {counts} != {expected}")
        for k in total:
            total[k] += counts[k]
            total_expected[k] += expected[k]

    # (a) the fixture matrix: every rule against its own fixtures
    t0 = time.perf_counter()
    matrix = []
    for rule in AR.ALL_RULES:
        for kind in ("bad", "good"):
            for prog in FIXTURES[rule.name][kind]:
                built = prog.build(dev)
                art, counts, expected = _record_counted(
                    torch, ops, AC, built, dev)
                add(counts, expected, prog.name)
                rows = AC.check_rules(prog.name, built, art, [rule])
                errs = [f["message"] for r in rows for f in r["findings"]
                        if f["severity"] == "error"]
                ok = bool(errs) == (kind == "bad")
                row = dict(rule=rule.name, program=prog.name, ok=ok,
                           errors=len(errs), first=errs[:1])
                if rule.name == "host-sync" and on_card:
                    row["sync_warnings"] = len(_sync_warnings(
                        torch, built.fn, built.args))
                    row["agree"] = (row["sync_warnings"] > 0) == bool(
                        errs)
                    ok = ok and row["agree"]
                if not ok:
                    problems.append(f"fixture {prog.name}: {row}")
                matrix.append(row)
    emit("analysis.fixtures", ok=all(r.get("agree", True) and r["ok"]
                                     for r in matrix),
         seconds=time.perf_counter() - t0, rows=matrix)

    # (b) every kernel's plan against the library's query
    if on_card:
        n_flat = param_count(cfg)
        n_pad = -(-n_flat // 1024) * 1024
        n_mask = max(1, int(round(n_flat * DENSITY)))
        for m in check_plans(torch, dev, n_pad, n_mask):
            problems.append(f"plan mismatch: {m}")

    # (c) the registry: clean, launches = kernel records, sync agreement;
    # each program in a one-rank process group, where fl_round_sharded's
    # 1x1 mesh lives (as analysis.core.run_program runs them)
    t0 = time.perf_counter()
    reg = []
    for prog in HOT_PATHS:
        with process_group(dev.type):
            row, counts, expected = _registry_row(torch, ops, AC, AR, prog,
                                                  dev, problems)
        add(counts, expected, prog.name)
        reg.append(row)
    emit("analysis.registry", ok=not any(r.get("errors") for r in reg),
         seconds=time.perf_counter() - t0, programs=reg)

    # (d) the full-width training burst under the recorder
    counts, expected, full = run_analysis_full(torch, dev, cfg, problems)
    add(counts, expected, "full-width make_fl_train_loop")
    emit("analysis", ok=not problems, problems=problems, **full)
    if problems:
        fail(f"analysis: {problems[:4]}")
    return total, total_expected


def _registry_row(torch, ops, AC, AR, prog, dev, problems):
    """One registry program built, recorded and checked: (its row, launch
    counts, the counts its kernel records imply)."""
    built = prog.build(dev)
    art, counts, expected = _record_counted(torch, ops, AC, built, dev)
    rows = AC.check_rules(prog.name, built, art, AR.ALL_RULES)
    errs = [f["message"] for r in rows for f in r["findings"]
            if f["severity"] == "error"]
    peak_bytes = next(f["detail"]["peak_bytes"] for r in rows
                      for f in r["findings"] if r["rule"] == "memory-ceiling"
                      and "detail" in f and "peak_bytes" in f["detail"])
    row = dict(program=prog.name, errors=errs[:3],
               launches={k: v for k, v in counts.items() if v},
               liveness_peak_bytes=peak_bytes,
               not_applicable=[r["rule"] for r in rows if r.get("skipped")])
    if dev.type == "cuda":
        syncs = _sync_warnings(torch, built.fn, built.args)
        rule_syncs = AR.host_sync_records(art.trace())
        row.update(sync_warnings=syncs[:3], n_sync=len(syncs),
                   rule_syncs=rule_syncs[:3],
                   agree=bool(syncs) == bool(rule_syncs))
        if not row["agree"]:
            problems.append(f"{prog.name}: sync debug mode and the "
                            f"host-sync rule disagree: {row}")
    if errs:
        problems.append(f"{prog.name}: {errs[:3]}")
    return row, counts, expected


def run_analysis_full(torch, dev, cfg, problems):
    """make_fl_train_loop on ``cfg`` at full width (AN_CLIENTS x AN_BATCH x
    SEQ_LEN, AN_STEPS steps, random weights from SEED, a random mask of
    DENSITY) under the recorder.  Returns (launch counts of the recorded
    call, the counts it implies, the numbers for the phase line)."""
    import numpy as np

    from repro_torch.analysis import core as AC
    from repro_torch.analysis import rules as AR
    from repro_torch.analysis import walk as AW
    from repro_torch.core import prng, random_mask
    from repro_torch.core.fl_step import make_fl_train_loop, make_fl_train_step
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.utils.tree import tree_leaves

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(seed=SEED)
    space = random_mask(params, density=DENSITY, seed=3, balanced=False)
    kw = dict(eps=1e-3, lr=1e-2, n_clients=AN_CLIENTS)

    def loss(p, b):
        return model.loss(p, b, per_example=True)

    loop = make_fl_train_loop(loss, space, n_steps=AN_STEPS, **kw)
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab, size=(AN_STEPS, AN_CLIENTS * AN_BATCH, SEQ_LEN),
        dtype=np.int32), device=dev)
    key = prng.key(1)
    built = AC.Built(loop, (params, key, {"tokens": tokens}))
    art = AC.Artifacts(built, dev)
    sync()
    setup_s = time.perf_counter() - t0

    rep = art.repeat()                    # warm-up, then the repeat
    t0 = time.perf_counter()
    loop(*built.args)
    sync()
    plain_s = time.perf_counter() - t0
    gc.collect()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    ops.reset_launches()
    t0 = time.perf_counter()
    trace = art.trace()
    sync()
    recorded_s = time.perf_counter() - t0
    counts = ops.launches()
    rise = (torch.cuda.max_memory_allocated() - before
            if on_card else None)
    rows = AC.check_rules("full_width_loop", built, art,
                          [r for r in AR.ALL_RULES
                           if r.name != "recompile-hazard"])
    expected = {name: 0 for name in counts}
    if on_card:
        expected.update({
            "zo_dual_perturb_flat": AN_STEPS,
            "zo_fused_update_flat": AN_STEPS,
            "flash_attention": AN_STEPS * 2 * cfg.n_layers})
    # the estimate the memory-ceiling rule applies (walk.liveness)
    est = AW.liveness(trace, device=dev.type)
    est_rise = est["peak_bytes"] - est["input_bytes"]
    live_rel = abs(est_rise - rise) / rise if rise else None
    errs = [f["message"] for r in rows for f in r["findings"]
            if f["severity"] == "error"]
    syncs = AR.host_sync_records(trace)
    blocks = AW.kernel_block_records(trace)
    max_block = max((b["block_bytes"] for b in blocks), default=0)
    if trace.raised:
        problems.append(f"full width: the recorded call raised "
                        f"{trace.raised}")
    if errs:
        problems.append(f"full width: {errs[:3]}")
    if syncs:
        problems.append(f"full width: host syncs {syncs[:3]}")
    if rep.get("raised") or rep["builds"] or rep["graphs"]:
        problems.append(f"full width: the repeat call {rep}")
    smem = trace.smem_optin or AR.SMEM_BUDGETS["h100"]
    if max_block > smem:
        problems.append(f"full width: a kernel block of {max_block} B")
    if on_card and live_rel > AN_LIVENESS_REL:
        problems.append(f"full width: liveness estimate {est_rise} B vs a "
                        f"measured rise of {rise} B ({live_rel:.3f})")

    # the loop against the step folded over the same batches and keys
    p_loop, g_loop, _ = loop(*built.args)
    step = make_fl_train_step(loss, space, **kw)
    p, gs = params, []
    for i, k in enumerate(prng.split(key, AN_STEPS)):
        p, g, _ = step(p, k, {"tokens": tokens[i]})
        gs.append(g)
    fold_equal = (torch.equal(g_loop, torch.stack(gs)) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(p_loop),
                                          tree_leaves(p))))
    finite = bool(torch.isfinite(g_loop).all())
    if not fold_equal:
        problems.append("full width: the loop differs from the folded step")
    if not finite:
        problems.append("full width: non-finite projected gradients")
    del p_loop, p, g_loop, gs
    z_ms = z64_ms = z_diff = None
    if on_card:
        z_ms, z64_ms, z_diff = time_sample_z(torch, space, key, dev)
        if z_diff > Z_F64_ABS:
            problems.append(f"full width: sample_z differs from the float64 "
                            f"Horner form by {z_diff}")
    full = dict(
        model=cfg.name, n_params=model.n_params, mask_coords=space.n,
        clients=AN_CLIENTS, client_batch=AN_BATCH, seq_len=SEQ_LEN,
        steps=AN_STEPS, setup_s=setup_s,
        step_s=plain_s / AN_STEPS, step_s_recorded=recorded_s / AN_STEPS,
        recorder_overhead=recorded_s / plain_s - 1.0,
        records=len(trace.records),
        kernel_records=sum(1 for r in trace.records if r.kind == "kernel"),
        launches={k: v for k, v in counts.items() if v},
        expected_launches={k: v for k, v in expected.items() if v},
        repeat=rep, host_syncs=len(syncs), rule_errors=errs[:3],
        max_kernel_block_bytes=max_block, smem_optin=smem,
        liveness_peak_bytes=est["peak_bytes"],
        liveness_input_bytes=est["input_bytes"],
        liveness_rise_bytes=est_rise, measured_rise_bytes=rise,
        liveness_rel_err=live_rel, liveness_rel_bound=AN_LIVENESS_REL,
        fold_bit_equal=fold_equal, finite=finite,
        sample_z_ms=z_ms, sample_z_f64_horner_ms=z64_ms,
        sample_z_f64_max_abs_diff=z_diff,
        dense_rule=f"not applicable: vocab {cfg.vocab} > S = {SEQ_LEN} "
                   f"(the rule needs S above every other dim)")
    return counts, expected, full


def _normal_f64_horner(torch, prng, key, n, dev):
    """``prng.normal`` with erfinv's Horner steps taken in float64, the form
    the float32 FMA of ``prng._fma`` replaced; kept here to time the two."""
    u = prng.uniform(key, n, prng._NEXT_ABOVE_MINUS_ONE, 1.0, dev)
    w = -torch.log1p(-u * u)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    wd = w.double()
    p = None
    for a, b in zip(prng._ERFINV_LT5, prng._ERFINV_GE5):
        c = torch.where(lt, a, b)
        p = c if p is None else (c.double() + p.double() * wd).float()
    x = torch.where(u.abs() == 1, u * torch.finfo(torch.float32).max, p * u)
    return torch.full((), math.sqrt(2), dtype=torch.float32,
                      device=dev) * x


def time_sample_z(torch, space, key, dev):
    """ms of ``space.sample_z`` (the mask's normals, erfinv by float32
    FMAs) and of the float64-Horner form on the same key, and their
    largest difference."""
    from repro_torch.core import prng
    z = space.sample_z(key)
    z64 = _normal_f64_horner(torch, prng, key, space.n, dev)
    diff = float((z - z64).abs().max())
    return (timed(lambda: space.sample_z(key), 20),
            timed(lambda: _normal_f64_horner(torch, prng, key, space.n, dev),
                  20), diff)


def profile_step(torch, name, step):
    """One more step (``step()``) under torch.profiler, after a warm one:
    device time by kernel, by kind, and the device's idle share of the
    step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()  # warm: allocator and caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (us if us is not None else e.self_cuda_time_total) / 1e3

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_ms(e) > 0]
    kinds = {"gemm": 0.0, "ported_kernels": 0.0, "other": 0.0}
    ported = ("flash_fwd", "flash_bwd", "dual_perturb_kernel",
              "fused_update_kernel", "gradip_", "decode_attn",
              "mamba_scan_kernel")
    by_ported = {}
    for e in kern:
        key = e.key.lower()
        tag = next((t for t in ported if t in e.key), None)
        kind = ("ported_kernels" if tag else
                "gemm" if ("gemm" in key or "cutlass" in key
                           or "xmma" in key) else "other")
        kinds[kind] += dev_ms(e)
        if tag:
            by_ported[tag] = by_ported.get(tag, 0.0) + dev_ms(e)
    busy = sum(kinds.values())
    top = sorted(kern, key=dev_ms, reverse=True)[:12]
    emit(f"profile.{name}", traced=bool(kern), wall_ms=wall_ms,
         device_busy_ms=busy, idle_share=1 - busy / wall_ms if kern else None,
         by_kind_ms=kinds, ported_ms=by_ported,
         top=[{"kernel": e.key[:90], "ms": dev_ms(e), "calls": e.count}
              for e in top])


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repo "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing ran", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    EMPTY_TABLE.mkdir(parents=True, exist_ok=True)
    try:
        return _main(torch)
    finally:
        shutil.rmtree(EMPTY_TABLE, ignore_errors=True)
        shutil.rmtree(TUNED_TABLE, ignore_errors=True)


def _main(torch) -> int:
    use_table(EMPTY_TABLE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    from repro_torch.configs import (CHATGLM3_6B, GEMMA2_2B, JAMBA_1_5_LARGE,
                                     LLAMA32_1B, PHI35_MOE, PIXTRAL_12B,
                                     QWEN3_4B, WHISPER_SMALL, XLSTM_350M)
    from repro_torch.configs.jamba_1_5_large_398b import SLICE_CUT
    from repro_torch.configs.tiny import TINY
    from repro_torch.kernels import build, ops, ref
    t0 = time.perf_counter()
    build.load()
    log = build.BUILD_DIR / "ptxas.log"
    text = log.read_text() if log.exists() else ""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores", text)]
    by_kernel = ptxas_spills(text)
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.build_seconds, kernel_functions=len(regs),
         max_registers=max(regs, default=None), spill_bytes=sum(spills),
         spills_by_kernel=by_kernel,
         source_seconds=dict(re.findall(r"== (\S+) ([\d.]+) s", text)))
    spilled = sorted(k for k in by_kernel if k.startswith("flash_")
                     and not tiling_is_default(k))
    if spilled:
        fail(f"flash tilings past the default spill registers: {spilled}")

    from repro_torch.models.init import param_count
    n_flat = param_count(LLAMA32_1B)
    n_pad = -(-n_flat // 1024) * 1024
    n_mask = max(1, int(round(n_flat * DENSITY)))
    # the flat and GradIP sizes of phases lora (the adapters' coordinates)
    # and slice_qwen3 (its mask)
    llama_lora = LLAMA32_1B.replace(lora_rank=LORA_RANK)
    qwen3 = QWEN3_4B.replace(n_layers=QWEN3_LAYERS)
    n_lora, n_qwen3 = param_count(llama_lora), param_count(qwen3)
    flat_extra = {"lora": -(-n_lora // 1024) * 1024,
                  "qwen3": -(-n_qwen3 // 1024) * 1024}
    gradip_extra = {"lora": n_lora - n_flat,
                    "qwen3": max(1, int(round(n_qwen3 * DENSITY)))}
    t0 = time.perf_counter()
    rows = {}
    rows.update(check_elementwise(torch, ops, ref, dev, n_pad, flat_extra))
    rows.update(check_gradip(torch, ops, ref, dev, n_mask, gradip_extra))
    gemma = GEMMA2_2B.replace(n_layers=GEMMA2_2B.period * 2)
    rows.update(check_flash(torch, ops, ref, dev, LLAMA32_1B, CLIENT_BATCH))
    pre = check_flash_prefill(torch, ops, ref, dev, gemma, GEMMA_PROMPTS)
    rows["flash_attention"]["tilings"]["gemma_prefill"] = {
        name: r["tilings"] for name, r in pre.items()}
    rows.update(check_flash_bwd(torch, ops, ref, dev, LLAMA32_1B, FO_BATCH,
                                gemma))
    rows.update(check_flash_decode(torch, ops, ref, dev, LLAMA32_1B,
                                   SERVE_SLOTS, SERVE_S_MAX, gemma))
    rows.update(check_mamba_scan(torch, ops, ref, dev))
    rows.update(check_fixture_double(torch, ops, ref, dev))
    chatglm3 = CHATGLM3_6B.replace(n_layers=CHATGLM_LAYERS)
    for name, extra in check_new_shapes(torch, ops, ref, dev, qwen3,
                                        chatglm3).items():
        rows[name].update(extra)
    for name, extra in check_serving_shapes(torch, ops, ref, dev).items():
        rows[name].update(extra)
    torch.cuda.empty_cache()
    emit("kernels", seconds=time.perf_counter() - t0, rows=rows)

    # one (Mamba, MoE) layer of Jamba at full width: 11.2 B parameters
    moe_layer = JAMBA_1_5_LARGE.replace(n_layers=1,
                                        layer_pattern=(("mamba", "moe"),))
    # one period of (attention, dense) and (Mamba, MoE): 11.9 B parameters
    jamba_serve = JAMBA_1_5_LARGE.replace(n_layers=2,
                                          layer_pattern=JAMBA_SERVE_PATTERN)
    families = (XLSTM_350M, WHISPER_SMALL,
                PIXTRAL_12B.replace(n_layers=PIXTRAL_LAYERS))
    # phase stack: TINY at the registry's width, Llama-3.2-1B, and Jamba
    # cut to its first STACK_JAMBA_LAYERS layers at full width
    stack_cfgs = (TINY.replace(vocab=256, d_model=256), LLAMA32_1B,
                  SLICE_CUT.replace(
                      n_layers=STACK_JAMBA_LAYERS,
                      layer_pattern=SLICE_CUT.layer_pattern[
                          :STACK_JAMBA_LAYERS]))
    launches = {name: 0 for name in KERNEL_SOURCES}
    for phase, run, cfg in (("slice", run_slice, LLAMA32_1B),
                            ("fleet", run_fleet, LLAMA32_1B),
                            ("mesh", run_mesh, LLAMA32_1B),
                            ("tp", run_tp, LLAMA32_1B),
                            ("lora", run_lora, llama_lora),
                            ("slice_qwen3", run_slice_qwen3, qwen3),
                            ("options", run_options,
                             (chatglm3, PHI35_MOE.replace(
                                 n_layers=PHI_LAYERS))),
                            ("first_order", run_first_order, LLAMA32_1B),
                            ("serve", run_serve_llama, LLAMA32_1B),
                            ("serve_gemma", run_serve_gemma, gemma),
                            ("grad_gemma", run_grad_gemma, gemma),
                            ("slice_jamba", run_slice_jamba, SLICE_CUT),
                            ("jamba_moe", run_jamba_moe, moe_layer),
                            ("serve_jamba", run_serve_jamba, jamba_serve),
                            ("families", run_families, families),
                            ("examples", run_examples, None),
                            ("analysis", run_analysis_phase, LLAMA32_1B),
                            ("stack", run_stack, stack_cfgs),
                            ("autotune", run_autotune,
                             (LLAMA32_1B, qwen3, chatglm3, gemma))):
        t0 = time.perf_counter()
        counts, expected = run(torch, dev, cfg)
        if counts != expected:
            fail(f"{phase}: launch counts {counts} != expected {expected}")
        for name in launches:
            launches[name] += counts[name]
        gc.collect()  # the phase's model and trees go before the next
        torch.cuda.empty_cache()
        emit(f"{phase}.done", seconds=time.perf_counter() - t0,
             resident_gb=torch.cuda.memory_allocated() / 1e9)
        if phase == "examples":
            run_hlo_tools_line()

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "enqueue_ms": r["enqueue_ms"],
                        **{k: r[k] for k in KERNEL_LINE_EXTRAS if k in r}})
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("total", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
