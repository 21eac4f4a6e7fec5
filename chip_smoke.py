#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`federated_pytorch_test_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--metrics-out PATH] [--lm-metrics-out PATH] [--vit-metrics-out PATH]
                          [--vit-moe-metrics-out PATH] [--vit-moe-bf16-metrics-out PATH]
                          [--admm-metrics-out PATH]
                          [--resnet-metrics-out PATH] [--no-consensus-metrics-out PATH]
                          [--scale64-metrics-out PATH] [--fan-metrics-out PATH]
                          [--lm-d128-metrics-out PATH] [--vit-d128-metrics-out PATH] [--profile]
    python3 chip_smoke.py --ab-parent DIR [--ab-phases phase_train,...]

The second form runs none of the phases below: it times the grouped GEMM
at every MoE ViT path shape (f32 and bf16 operands), the gram at every Net
group size, the assembly at every Net, Net1 and ResNet group size and the
train phases named by `--ab-phases` (default: the Net, LM, ViT and MoE ViT
trains; `phase_lm_d128`, `phase_vit_d128`, `phase_vit_bf16_train` and
`phase_vit_moe_bf16_train` may be named too), of the
checkout in DIR (e.g. the parent commit, `git archive`d) and of this one
in turns, in fresh processes (`run_ab`), with the bf16 trio and its
autograd forward and backward beside SDPA's (forward, backward and both)
and the f32 flash forward at
both precisions at the LM's and the ViT's shapes (D 16 and D 128); it also
says whether the bf16 grouped GEMM's outputs, the assembly's, the bf16
trio's, the f32 forward's and the train phases' loss series are equal in
bits across the turns of both checkouts, and how far the bf16 grouped
outputs of the two lie apart.

Phases, each reported on its own lines and followed by its wall (`phase
<name> seconds=`); any failure exits non-zero:

1. card     — `nvidia-smi` name and power limit;
2. build    — nvcc builds the port's five CUDA sources, all at once; ptxas's
              registers and spills and the SASS tensor-core instruction
              counts of every tensor-core instance (the flash forward and
              backward, causal and not, split and one-pass, the forward at
              D 128 and the one-pass forward at D 16 and dk/dv up to D 64
              kernels of their own; the bf16 flash
              trio, its forward and dk/dv at D 128 kernels of their own;
              the grouped GEMM's split-TF32 and bf16 instances), each
              of which must hold HGMMA and spill nothing;
3. kernels  — each compact-direction kernel against its plain PyTorch version
              on the card (K=3, m=10, N at every Net group size, one
              ResNet18-block-sized N, counts {0, 3, 10}, a zero-curvature
              slot and a NaN-filled invalid row), relative 1e-5 of the
              largest reference entry; times of the kernel, the plain
              version, one PyTorch library call computing the same function
              (a yardstick the port never calls) and the bound; the
              assembly twice on the same inputs, equal bits. Each
              time is taken twice: per call as the caller sees it, host
              launch path included (`ms`), and on the device alone with
              the calls queued behind a sleep kernel (`device_ms`). At the
              Net path's largest group the gram's kernels in one call are
              counted by the profiler (exactly one launch) and printed with
              its registers and its time beside its bound;
4. flash    — the three causal flash-attention kernels (the tensor-core
              kernels at Sq = Skv, shift 0) against their plain versions (D
              in {16, 32, 64, 128} x S in {128, 256, 1024, 2048} at BH=8, the
              headroom S=4096 at BH=8 and every D, and the LM paths' BH=128,
              S=2048 at D=16 and D=128): o and lse within relative 1e-5 of the largest
              reference entry, dq, dk, dv within 1e-4 (from S=2048 on, also
              printed against the plain version in float64); at the path's
              shape the forward and the dq, dk/dv pair twice on the same
              inputs (equal bits) and with q, k x 8 against the plain
              version in float64 (`fwd_extra_checks`, `bwd_extra_checks`);
              times at the path's shape beside two bounds (split TF32 on the
              tensor cores, exps, bytes; and the ceiling of an f32 FFMA
              design) and `scaled_dot_product_attention` (forward; backward)
              as the yardstick; then `padded_check`: the public op at D=80,
              which pads to the D-128 instance, against the plain versions at
              D=80, each kernel launched once, and its fwd+bwd time beside
              the op's at D=128 (the padding's price);
5. flash rect — the three rectangular flash kernels against their plain
              versions: non-causal at D in {16, 32, 64, 128} x S in {128, 256,
              1024} (BH=8; S=2048 at D=128, also read against float64), the
              ViT path's BH=6144, S=256, D=16 and the D-128 ViT's BH=3072,
              S=256, D=128; causal
              with global offsets (q_off, k_off) in {(0,0), (128,0),
              (0,128) fully future, (0,64) unaligned} and two s_q != s_kv
              cases (one at q_off 37, off the 64-key tile grid); same tolerances, and rows that see no key exactly o = 0,
              lse = -1e30; `flash_block`'s autograd with non-zero o and lse
              cotangents against autograd through the plain forward; the
              repeat and x8 checks of the forward, and of dq and dk/dv
              (`bwd_extra_checks`, within 1e-4 of float64 or twice the f32
              plain version's error), at both ViT shapes, non-causal and
              causal; times there beside the bounds and
              `scaled_dot_product_attention`; `padded_check` non-causal;
5a. flash default — the six one-pass ('default') flash kernels against
              their plain versions (which round as the kernels do, tile by
              tile): every output within 2^-10 of its largest entry, and at
              least 4x closer in RMS to the one-pass plain version than to
              'highest' (`onepass_check`); causal at S 1024 and the
              rectangular family non-causal and on offsets at every D, causal
              at S 128, 256 and 2048 at D 128, and the LM's and the ViT's
              shapes at D 16 and D 128, there (and at S 2048) also within
              2e-2 of float64; repeats equal bits; times beside the bound
              (one TF32 product, the exps or the bytes) and SDPA in f32;
              `padded_check` at 'default';
5b. flash bf16 — the bf16 causal trio (`cast16`) against its plain versions
              at every D (S 256, 1024; at D 128 also S 128 and 2048) and at
              (BH 128, S 2048, D 16), (BH 32, S 4096, D 64) and (BH 128,
              S 2048, D 128): o, lse and the bf16 cotangents within
              two bf16 units (2^-8) of their largest entry; the public op
              `flash_attention(q16, k16, v16, causal=True,
              precision='default')` forward and backward against float64
              dense attention at the JAX package's bounds, launching each
              of the trio exactly once; repeats equal bits; times beside
              the bound (bf16 products at 989 TFLOP/s, the exps or the
              bytes) and SDPA on the same bf16 inputs; `padded_check` bf16;
6. parity   — a tiny drive with the plain ('compact') and the fused-kernel
              ('pallas') direction on the card: the first averaging round's
              losses and dual residual agree within relative 1e-3;
7. train    — the fedavg path: the fedavg preset (Net, K=3, batch 512) on the
              full-size synthetic CIFAR-10 stand-in (50,000/10,000, seed 0)
              with the fused-kernel direction, one outer loop over all five
              groups, nadmm=3. Launch counts are zeroed just before and read
              just after; every compact kernel must have launched, exactly
              once per direction the optimizer's records count
              (`expected_launches`), losses must be finite and every
              client's accuracy above chance;
7a. net bf16 — phase 7's run at compute_dtype bf16: finite losses,
              accuracy above chance, compact launches exact;
8. lm parity — the LM's first round (K=4, S=256) step by step with
              'dense' attention (plain) and 'flash' (the kernels), both fed
              the same parameters and optimizer state before each step:
              losses, parameters and the round's dual residual agree within
              relative 1e-3 (over the whole round, L-BFGS amplifies 1e-6
              step differences past that in a fast-learning client);
9. lm train — the LM path (`federated_lm`, full width): K=4 TransformerLM
              clients (vocab 256, dim 64, 4 heads, 2048 positions) on
              sequences of 2048 tokens, batch 8, 4 minibatches, one outer
              loop over all six groups with flash attention. Flash launch
              counts are zeroed just before and read just after; every flash
              kernel must have launched exactly as often as the run's
              records imply (`expected_launches`: the backward once per
              gradient pass in each layer behind the active group, the
              forward once per model pass in every layer), losses must be
              finite and every client's next-token accuracy above 5/vocab;
9a. lm model — TransformerLM at full width (K=4 clients of 8 sequences
              of 2048 tokens) at attn_precision 'default' and dtype bf16,
              forward and backward: the one-pass causal kernels launch once
              a block each; loss within 3e-2 of the f32 'highest' model's,
              gradient cosine at least 0.99; then the attention core dense
              against flash at S 128 to 2048 at both precisions (the card's
              'auto' crossover);
9b. lm d128 — the LM at head dim 128 (`LM128_DIMS`: dim 512, 4 heads of
              128, LMConfig's other defaults): one round of block0's group
              through `federated_lm` at 'highest' (the causal split kernels
              at BH=128, S=2048, D=128), launches gated exactly, finite
              losses, accuracy above 5/vocab; then phase 9a's check of the
              model at bf16/'default' (the one-pass causal kernels at D 128)
              against f32/'highest';
10. vit parity — the ViT's first round (patch 2: 256 tokens, batch 64)
              step by step with 'dense' attention (plain) and 'flash' (the
              rectangular kernels), fed the same parameters and optimizer
              state before each step: losses, parameters and the dual
              residual agree within relative 1e-3;
11. vit train — the ViT path: the fedavg preset with `model="vit"`,
              `model_kwargs={"patch": 2, "attn_impl": "flash"}` (dim 64, 4
              heads, 217,930 parameters per client, K=3, batch 512) and the
              fused-kernel direction, on a synthetic stand-in of 12,288 train
              images (8 minibatches of 512 per client) and 10,000 test
              images, one outer loop over all six groups, nadmm=1. Launch
              counts are zeroed just before and read just after; every
              rectangular flash kernel and compact kernel must have
              launched, exactly as often as the run's records imply, losses
              must be finite and every client's accuracy above chance;
11a. vit bf16 — phase 11's run at compute_dtype bf16 and attn_precision
              'default' (the one-pass rectangular kernels), launches gated
              exactly; then the same with `remat` (the forward launches once
              more a gradient pass): the trajectory equal within 1e-5, walls
              and peak memory of both;
11b. vit d128 — the ViT at head dim 128 (`VIT128_KWARGS`: dim 256, 2 heads
              of 128, patch 2): the fedavg preset's round of block1 at f32
              (the rectangular split kernels at BH=3072, S=256, D=128) and at
              compute_dtype bf16 with attention at 'default' (the one-pass
              rectangular kernels), flash and compact launches gated
              exactly, finite losses, every client above chance;
12. grouped — the grouped GEMM (`ops/grouped_gemm.py`) at every shape of
              the MoE ViT path (K=3 clients x E=8 experts = 24 groups,
              20,480 slots an expert, D=64, H=256): both forwards, the
              evaluation forward (20,000 slots), both input gradients (B
              a transposed view) and both weight gradients (A a transposed
              view, the contraction over the slots split in 20): the kernel
              against its plain version in float64 within relative 1e-5 of
              the largest reference entry, two launches equal bits, the
              split sum equal to its plain version; every role likewise at
              the ragged shapes (G, M, K, N) = (3, 13, 257, 9) and (3, 300,
              40, 270); times of the kernel,
              the plain version and `torch.bmm` (TF32 off) beside the bound
              (the bytes, or three TF32 products) and the FFMA ceiling; the
              split sum's with the L2 cache flushed before every call, so
              that its bytes bound holds (each reading must not beat it);
12″. grouped bf16 — the bf16 grouped GEMM (`csrc/grouped_gemm_bf16.cu`:
              persistent, TMA loads, staged 16-byte stores; the weight
              gradients split in 5) on bf16 operands at every shape of
              phase 12 and both ragged shapes: within two bf16 units of the
              largest entry of the float64 product of the same bf16
              operands, rounded to bf16; two launches equal bits; the bf16 split sum equal in bits to
              its plain version; times of the kernel, the plain version and
              `torch.bmm` on the bf16 operands beside the bound (bf16
              products at 989 TFLOP/s or the bytes);
13. vit_moe parity — the MoE ViT's block-0 round (its experts train; the
              gradient crosses every block) step by step at batch 128: the
              plain side ('dense' attention, the grouped GEMM's plain
              version) and the kernel side ('flash', the grouped kernel) fed
              the same parameters and optimizer state before each step:
              losses, parameters and the dual residual within relative 1e-3;
14. vit_moe train — the switch-MoE ViT path: phase 11's configuration with
              `moe_experts=8` (1,146,474 parameters per client,
              `moe_aux_coef` 0.01), one outer loop over all six groups,
              nadmm=1. Launch counts are zeroed just before and read just
              after; every grouped, rectangular flash and compact kernel
              must have launched exactly as often as the run's records imply
              (`expected_grouped`), losses must be finite and every
              client's accuracy above chance;
14″. vit_moe bf16 — phase 14 at compute_dtype bf16 with attn_precision
              'default': launches of the bf16 grouped roles, the one-pass
              rectangular flash kernels and the compact pair gated exactly;
              finite losses, every client above chance; wall and peak
              printed beside phase 14's;
15. admm train — the admm path: the admm preset (Net, K=3, batch 512,
              nadmm 5, BB rho from 1e-3) on the full-size synthetic stand-in
              with the fused-kernel direction, one outer loop over all five
              groups. Compact launches gated exactly; losses and residuals
              finite; every client's accuracy above chance; each group's
              mean rho per round and final per-client rho printed, each
              rho either rho0 or an accepted BB value in (0, bb_rhomax);
16. resnet parity — admm_resnet at full width (ResNet18, 11,173,962
              parameters a client): block7's round (group 8, N = 4,720,640,
              the largest group; nadmm 3 x 16 minibatches of 32) step by
              step with the plain direction in float64 (`direction_f64`:
              at this N the float32 plain version's sums stray further
              from float64 than the kernel's; the first step prints both
              distances) and the 'pallas' direction, fed the same
              parameters, BatchNorm statistics, optimizer and ADMM state
              before each step: losses, parameters,
              statistics and the primal and dual residuals within
              relative 1e-3;
17. resnet train — the ResNet paths at full width with the fused-kernel
              direction on a synthetic stand-in of 1,536 train images (16
              minibatches of 32 a client) and 2,000 test images (a
              `reduced` line):
              admm_resnet over all ten groups in the preset's shuffled order,
              nadmm 3; then fedavg_resnet over its first three groups, nadmm
              1. Compact launches gated exactly on both runs; losses and
              residuals finite; every BatchNorm running statistic finite and
              moved from its initial value; accuracies and walls printed.
              Then both compact kernels at every group size the paths
              reached: against the plain version (relative 1e-5) and timed
              beside the bytes bound and the `matmul` yardstick;
18. no_consensus train — the no_consensus path: the no_consensus preset
              (Net1, K=3, batch 32, independent clients from their own
              initial draws, the whole vector of 890,410 one group, the
              elastic net on fc1 only) on the full-size synthetic stand-in
              with the fused-kernel direction, 2 of its 12 epochs (a
              `reduced` line says so), evaluated after every epoch and at
              the end. Compact
              launches gated exactly; losses finite; every
              client's accuracy above chance; the clients' parameters
              pairwise different; one minibatch's objective within relative
              1e-5 of the data loss plus λ1‖fc1‖₁ + λ2‖fc1‖² computed apart
              in float64;
19. compact at 890,410 — both compact kernels and the kernel direction at
              the no_consensus path's N, and at 890,408 beside it (rows
              16-byte aligned), against the plain version computed
              in float64 (relative 1e-5), timed beside the bound, the plain
              version and the `matmul` yardstick; the plain `two_loop`
              direction at 48,120 and 890,410 against the plain compact
              direction in float64 (relative 1e-5), timed beside the kernel
              direction;
20. resume   — on the card, under the port's defaults: fedavg (Net, two groups)
              and admm (Net's first group, nadmm 5, BB with its thresholds
              opened so that the second loop starts from an accepted rho),
              each run for two outer loops straight and for one loop with
              `save_model` then continued by a fresh Trainer with
              `load_model=True`: final parameters, rho store and the second
              loop's series bitwise equal (the largest differences printed
              either way), on 12,288 train images (a `reduced` line);
20a. repeat  — the first round of the Net fedavg path (conv1), admm_resnet
              (conv1), the LM (its embedding), the ViT and the MoE ViT at
              f32 and bf16 (block0), each run twice from a fresh Trainer
              under the port's defaults (deterministic cuDNN): final
              parameters and loss series bitwise equal (a `reduced` line:
              1,000 test images);
21. scale64 — the two scale64 presets (K=64 ResNet18 clients on CIFAR-100,
              the 64 clients the batch axis of one card) at full width on
              8,192 synthetic train images (4 minibatches of 32 a client; a
              `reduced` line): fedavg_scale64 over one round of block7 (N =
              4,720,640, the largest group, its `[64, 10, N]` history updated
              in place), nadmm 1, and admm_scale64 over one round of the
              linear head (N = 51,300), nadmm 3, with the fused-kernel
              direction. Compact launches gated exactly; losses and
              residuals finite; every BatchNorm running statistic finite and
              moved; the peak of allocated memory printed and below the
              card's. Then both compact kernels at K=64 at both N: clients 0,
              31 and 63 against the plain version in float64 (relative
              1e-5), timed beside the bytes bound and the `matmul` yardstick;
22. probe fan — the fedavg preset (Net, K=3, phase 7's inputs, fused-kernel
              direction) at `linesearch_probes=1`, its loss series bitwise
              equal to phase 7's over the whole loop, then at 4 under `client_fold` 'gemm' and 'vmap': compact
              launches gated, the accepted step sizes of every step equal to
              those at 1; walls and the optimizer's host reads of each; then
              one ViT round (block1) at 4 with the rectangular flash and
              compact launches gated.

The second-to-last line is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`. Without CUDA, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core rate; split TF32 takes three products
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
EXPS_PER_S = 16 * 132 * 1.83e9  # exp2 on the SFUs: 16 a clock per SM, 132 SMs, 1.83 GHz boost
M, K = 10, 3
NET_GROUP_SIZES = (456, 2416, 48120, 10164, 850)
LARGE_N = 4_720_644  # ~ResNet18's largest block group; not a multiple of any tile
REPORT_N = 48120  # the main path's largest group (fc1): the shape the JSON line reports
RTOL = 1e-5
SOURCES = ("compact_direction", "flash_attention", "flash_bf16", "grouped_gemm", "grouped_gemm_bf16")  # csrc/<name>.cu
FLASH_DIMS = (16, 32, 64, 128)
FLASH_SEQS = (128, 256, 1024, 2048)
FLASH_SWEEP_BH = 8
FLASH_PATH = (128, 2048, 16)  # (BH, S, D) of the LM path: K·batch·heads, sequence, head dim
# the LM at head dim 128: LMConfig(dim=512, num_heads=4), a Llama-style head on the
# repo's TransformerLM, the rest at its defaults (K=4, batch 8, S 2048): K·batch·heads 128
LM128_DIMS = {"dim": 512, "num_heads": 4}
LM128_PATH = (128, 2048, 128)
PADDED_D = 80  # a head dim between instances: the public entries pad it to 128
FLASH_HEADROOM_S = 4096  # a sequence beyond the LM's, at BH=8 and every D
FLASH_GRAD_RTOL = 1e-4
FLASH_REPLACES = {
    "flash_fwd": "federated_pytorch_test_tpu/ops/flash_attention.py:559",
    "flash_bwd_dq": "federated_pytorch_test_tpu/ops/flash_attention.py:655",
    "flash_bwd_dkv": "federated_pytorch_test_tpu/ops/flash_attention.py:673",
}
RECT_SEQS = (128, 256, 1024)
RECT_PATH = (6144, 256, 16)  # (BH, S, D) of the ViT path: K·batch·heads, tokens, head dim
# (s_q, s_kv, q_off, k_off) of the causal/offset checks, at BH=8; the last
# gives the D-128 forward blocks of an odd count of 32-key tiles
RECT_OFFSETS = ((256, 256, 0, 0), (256, 256, 128, 0), (128, 128, 0, 128), (256, 256, 0, 64), (128, 384, 256, 64),
                (128, 256, 37, 0), (256, 256, 0, 32))
RECT_REPLACES = {
    "flash_fwd_rect": "federated_pytorch_test_tpu/ops/flash_attention.py:601",
    "flash_bwd_dq_rect": "federated_pytorch_test_tpu/ops/flash_attention.py:721",
    "flash_bwd_dkv_rect": "federated_pytorch_test_tpu/ops/flash_attention.py:744",
}
VIT_KWARGS = {"patch": 2, "attn_impl": "flash"}
# the ViT at head dim 128: dim 256, 2 heads; K·batch·heads 3·512·2 over 256 tokens
VIT128_KWARGS = {**VIT_KWARGS, "dim": 256, "num_heads": 2}
VIT128_PATH = (3072, 256, 128)
VIT_TRAIN, VIT_TEST = 12_288, 10_000  # 8 minibatches of 512 per client; the full test set
VIT_MOE_KWARGS = {**VIT_KWARGS, "moe_experts": 8}  # the JAX config's own example of E
GROUPED_REPLACES = "federated_pytorch_test_tpu/ops/grouped_gemm.py:74"
GROUPED_TAILS = ((3, 13, 257, 9), (3, 300, 40, 270))  # (G, M, K, N) from the card test's list
# the bf16 grouped kernel from the float64 product of its operands rounded to
# bf16: bf16 units (2^-8) of the largest entry (`bf16_units`)
GROUPED_BF16_UNITS = 2.0
LARGE_SLACK = 2.0  # q, k x 8: the kernel's error from float64 may reach this multiple of the f32 plain version's
QUEUED_CALLS = 50  # calls queued per device-only timing (a plain version launches ~8 kernels)
# 16 minibatches of 32 per client; 2,000 of the 10,000 test images (the 30
# evaluations of the full set took 114 s of the phase's ~210 s)
RESNET_TRAIN, RESNET_TEST = 1_536, 2_000
NO_CONSENSUS_N = 890_410  # Net1, the no_consensus path's one group: the whole vector
ALIGNED_NO_CONSENSUS_N = 890_408  # beside it, the nearest N whose rows are 16-byte aligned
NO_CONSENSUS_EPOCHS = 2  # of the preset's 12
NO_CONSENSUS_PROFILE_STEPS = 50  # minibatches of the profiled no_consensus window, of ~520
RESUME_TRAIN = 12_288  # 8 minibatches of 512 per client
SCALE64_K = 64  # the scale64 presets' clients
SCALE64_TRAIN, SCALE64_TEST = 8_192, 500  # 4 minibatches of 32 a client; the presets evaluate nothing
SCALE64_SIZES = (4_720_640, 51_300)  # ResNet18's block7 and its 100-class head
SCALE64_CHECK = (0, 31, 63)  # the clients held against float64
FAN_PROBES = 4  # linesearch_probes of the fan phase
# a fan's loss at a rung against the sequential search's: float32's
# resolution of a cross-entropy near a memorized batch (1 − p rounds in
# steps of 2^-24, twice that), or relative 1e-6
FAN_TIE_ATOL, FAN_TIE_RTOL = 2.0**-23, 1e-6


def timed(phase, *args, **kwargs):
    """`phase(*args, **kwargs)`, its wall printed after it (`phase <name> seconds=`)."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    print(f"phase {phase.__name__} seconds={time.perf_counter() - t0:.3f}", flush=True)
    return out


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, iters: int, queued: int = QUEUED_CALLS) -> tuple:
    """Mean milliseconds per call over `iters` back-to-back calls, after
    warm-up, as (per call with the host's launch path, device alone;
    `queued` = 0: the first reading twice).

    The first reading times the calls as issued: where the host issues
    slower than the card runs, it measures the host. For the second, a
    sleep kernel holds the stream while the host queues every call, so
    the events bracket the kernels alone; the sleep grows until it
    outlasts the queueing. At most `queued` calls are queued: the
    driver's launch queue holds about a thousand launches, and the host
    blocks once it is full."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    host_ms = start.elapsed_time(stop) / iters
    if queued == 0:
        return host_ms, host_ms
    n_queued = min(iters, queued)
    cycles = 10_000_000
    while True:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n_queued):
            fn()
        stop.record()
        queued = not start.query()  # the card had not left the sleep yet
        torch.cuda.synchronize()
        if queued:
            return host_ms, start.elapsed_time(stop) / n_queued
        if cycles > 1 << 34:
            fail("time_ms: could not queue the calls ahead of the card")
        cycles *= 4


def time_cold_ms(fn, iters: int) -> tuple:
    """As `time_ms`, with the L2 cache flushed before every call, so that
    the call reads its inputs from device memory as a bytes bound assumes.
    The flush writes, then reads, 256 MB (five times the H100's 50 MB L2):
    the write evicts every other line, the read leaves clean lines whose
    eviction costs the call no write-back. The device reading queues each
    call behind a sleep kernel, as `time_ms` does."""
    import torch

    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn()
    host = device = 0.0
    cycles = 10_000_000
    for _ in range(iters):
        flush.zero_()
        flush.sum()
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        host += start.elapsed_time(stop)
        while True:
            flush.zero_()
            flush.sum()
            torch.cuda._sleep(cycles)
            start.record()
            fn()
            stop.record()
            queued = not start.query()  # the card had not left the sleep yet
            torch.cuda.synchronize()
            if queued:
                break
            if cycles > 1 << 34:
                fail("time_cold_ms: could not queue the call ahead of the card")
            cycles *= 4
        device += start.elapsed_time(stop)
    return host / iters, device / iters


def rel_err(out, ref) -> float:
    scale = float(ref.abs().max())
    return float((out - ref).abs().max()) / (scale if scale > 0 else 1.0)


def ptxas_lines(lib):
    """(mangled entry function, line) of every ptxas register, spill or
    warning line in the build log beside `lib`."""
    fn = None
    for line in lib.with_suffix(".log").read_text(errors="replace").splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif fn and ("Used" in line or "spill" in line or "warning" in line.lower()):
            yield fn, line.strip()


def spill_bytes(line: str) -> int:
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    return int(m.group(1)) + int(m.group(2)) if m else 0


def sass_functions(lib):
    """(mangled name, SASS) of every kernel in `lib`, from cuobjdump; None
    when the toolkit has no cuobjdump."""
    import shutil

    nvcc_dir = os.path.dirname(os.path.realpath(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"))
    tool = shutil.which("cuobjdump") or os.path.join(nvcc_dir, "cuobjdump")
    if not os.path.exists(tool):
        print("sass cuobjdump not found: tensor-core instructions not counted", flush=True)
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    return [(chunk.split("\n", 1)[0].strip(), chunk) for chunk in sass.split("Function : ")[1:]]


def report_tensor_core_build(lib, label, tc) -> None:
    """What the compiler made of the tensor-core instances in `lib` (those
    whose mangled name `tc` labels, else None): ptxas's registers, shared
    memory and spills, any warning, and the count of tensor-core
    instructions in each instance's SASS (and of the waits for them,
    `DEPBAR`: one after every HGMMA where ptxas serialized them). Every
    instance must hold HGMMA and spill nothing."""
    seen = set()
    for fn, line in ptxas_lines(lib):
        name = tc(fn)
        if name is None and "warning" not in line.lower():
            continue
        print(f"ptxas {name or ''} {line}", flush=True)
        seen.add(name)
        if name and spill_bytes(line):
            fail(f"{name} spills: {line}")
    if not seen - {None}:
        fail(f"{label}: the build log has no ptxas report of its tensor-core instances")
    for fn, chunk in sass_functions(lib) or ():
        name = tc(fn)
        if name:
            print(f"sass {name} HGMMA={chunk.count('HGMMA')} HMMA={chunk.count('HMMA')} "
                  f"MUFU.EX2={chunk.count('MUFU.EX2')} DEPBAR={chunk.count('WARPGROUP.DEPBAR')}", flush=True)
            if "HGMMA" not in chunk:
                fail(f"{name}: no HGMMA in its SASS")


TC_KERNELS = ("flash_fwd_tc", "flash_fwd_d128_tc", "flash_fwd_1p_tc", "flash_bwd_dq_tc",  # the tensor-core flash kernels
              "flash_bwd_dq_d128_tc", "flash_bwd_dkv_tc", "flash_bwd_dkv_d128_tc", "flash_bwd_dkv_1p_tc", "flash_fwd_bf16_tc",
              "flash_fwd_bf16_d128_tc",
              "flash_bwd_dq_bf16_tc", "flash_bwd_dkv_bf16_tc", "flash_bwd_dkv_bf16_d128_tc")


def flash_label(mangled: str):
    """`flash_bwd_dq_tc<16, true, false>` (D, causal, split) or
    `flash_fwd_bf16_tc<64, 128, 0>` (D, keys a tile, cut) from a tensor-core
    flash instance's mangled name."""
    name = next((k for k in TC_KERNELS if k + "I" in mangled), None)
    if name is None:
        return None
    m = re.match(r"((?:L[ib]\d+E)+)E", mangled.split(name + "I", 1)[1])
    if not m:
        return name
    args = [v if kind == "i" else ("true" if v == "1" else "false")
            for kind, v in re.findall(r"L([ib])(\d+)E", m.group(1))]
    return f"{name}<{', '.join(args)}>"


def grouped_label(mangled: str):
    """`grouped_gemm_tc<128, A, BT>` from a grouped GEMM instance's mangled
    name (A, B: the operand's contraction axis contiguous; AT, BT: not)."""
    m = re.search(r"grouped_gemm_tcILi(\d+)ELb([01])ELb([01])E", mangled)
    if not m:
        return None
    return f"grouped_gemm_tc<{m.group(1)}, {'A' if m.group(2) == '1' else 'AT'}, {'BT' if m.group(3) == '1' else 'B'}>"


def grouped_bf16_label(mangled: str):
    """`grouped_gemm_bf16_tc<128, 256, A, BT, 1>` (output tile, layouts, CTAs
    an SM) from a bf16 grouped GEMM instance's mangled name (A, BT: read
    K-major; AT, B: read MN-major)."""
    m = re.search(r"grouped_gemm_bf16_tcILi(\d+)ELi(\d+)ELb([01])ELb([01])ELi(\d+)E", mangled)
    if not m:
        return None
    return (f"grouped_gemm_bf16_tc<{m.group(1)}, {m.group(2)}, {'A' if m.group(3) == '1' else 'AT'}, "
            f"{'BT' if m.group(4) == '1' else 'B'}, {m.group(5)}>")


def history(n: int, seed: int):
    """Seeded [K, m, N] history like the optimizer's: y ≈ B s with B SPD,
    client 1 has a NaN-filled invalid row (5 >= count 3), client 2 a
    zero-curvature slot (4)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = 0.1 * torch.randn(K, M, n, device="cuda", generator=gen)
    d = 0.5 + 1.5 * torch.rand(K, 1, n, device="cuda", generator=gen)
    y = s * d + 0.01 * torch.randn(K, M, n, device="cuda", generator=gen)
    g = torch.randn(K, n, device="cuda", generator=gen)
    s[1, 5] = float("nan")
    y[1, 5] = float("nan")
    y[2, 4] = 0.0
    count = torch.tensor([0, 3, 10], dtype=torch.int32, device="cuda")
    h_diag = torch.tensor([1.0, 0.7, 1.3], device="cuda")
    return s, y, g, count, h_diag


def phase_kernels():
    """Each kernel against its plain version at every shape; timings."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.optim.compact import compact_direction, compact_solves, history_valid

    report = {}
    for n in (*NET_GROUP_SIZES, LARGE_N):
        s, y, g, count, h_diag = history(n, seed=n)
        gram = cc.fused_gram_projections(s, y, g, count)
        gram_ref = cc.fused_gram_projections_plain(s, y, g, count)
        errs = {f"gram.{nm}": rel_err(a, b) for nm, a, b in zip(("sy", "yy", "p", "q"), gram, gram_ref)}
        sy, yy, p, q = gram_ref
        u, w, _, _ = compact_solves(sy, p, q, history_valid(count, M), h_diag,
                                    lambda uu: (torch.matmul(yy, uu[..., None])[..., 0], None))
        asm = cc.fused_direction_assembly(s, y, g, w, u, h_diag, count)
        asm_ref = cc.fused_direction_assembly_plain(s, y, g, w, u, h_diag, count)
        errs["assembly"] = rel_err(asm, asm_ref)
        asm_repeat = bitwise_equal(asm, cc.fused_direction_assembly(s, y, g, w, u, h_diag, count))
        direction = cc.compact_direction_cuda(g, s, y, count, h_diag)
        errs["direction"] = rel_err(direction, compact_direction(g, s, y, count, h_diag))
        # for information: both sides against a float64 reference of the projections
        valid = history_valid(count, M)[..., None]
        s64 = torch.where(valid, s, 0.0).double()
        pq64 = (s64 * g.double()[:, None]).sum(-1)
        info = f"p_vs_f64 kernel={rel_err(gram[2].double(), pq64):.3e} plain={rel_err(gram_ref[2].double(), pq64):.3e}"
        del s64
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t).all()) for t in (*gram, asm, direction))
        worst = max(errs.values())
        print(f"kernels N={n} " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + f" finite={finite} assembly_repeat_bitwise={asm_repeat} {info}", flush=True)
        if not finite or not worst <= RTOL:
            fail(f"kernel disagrees with its plain version at N={n}: {errs} (finite={finite})")
        if not asm_repeat:
            fail(f"fused_direction_assembly: two calls on the same inputs differ in bits at N={n}")

        # timings with a full history (count = m for every client): the
        # steady state of the optimizer, and every row is read
        rows = compact_timings(s, y, g, w, u, h_diag, n)
        if n == REPORT_N:
            report.update(rows)
        if n == REPORT_N:
            full = torch.full((K,), M, dtype=torch.int32, device="cuda")
            gram_one_launch(lambda: cc.fused_gram_projections(s, y, g, full), report["fused_gram_projections"])
    return report


def compact_timings(s, y, g, w, u, h_diag, n: int) -> dict:
    """Both compact kernels with a full history (count = m for every client:
    the optimizer's steady state, every row read; the NaN rows of `history`
    zeroed in place): the largest difference from the plain version, and
    the times of the kernel, the plain version and one PyTorch library
    call computing the same function (a `matmul`, never called by the
    port) beside the bound. Printed as `timing` lines; returns the rows."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc

    full = torch.full((K,), M, dtype=torch.int32, device="cuda")
    s.nan_to_num_(0.0)
    y.nan_to_num_(0.0)
    iters = 20 if n > 200_000 else 200  # the plain and library calls take milliseconds from here
    x = torch.cat([s, y, g[:, None]], dim=1)  # [K, 2m+1, N] for the library calls
    coef = torch.cat([w, -h_diag[:, None] * u, h_diag[:, None]], dim=1)[:, None, :]  # [K, 1, 2m+1]
    gram_full = cc.fused_gram_projections(s, y, g, full)
    gram_full_ref = cc.fused_gram_projections_plain(s, y, g, full)
    asm_full = cc.fused_direction_assembly(s, y, g, w, u, h_diag, full)
    asm_full_ref = cc.fused_direction_assembly_plain(s, y, g, w, u, h_diag, full)
    calls = {
        "fused_gram_projections": (
            lambda: cc.fused_gram_projections(s, y, g, full),
            lambda: cc.fused_gram_projections_plain(s, y, g, full),
            lambda: torch.matmul(x, x.transpose(1, 2)),
        ),
        "fused_direction_assembly": (
            lambda: cc.fused_direction_assembly(s, y, g, w, u, h_diag, full),
            lambda: cc.fused_direction_assembly_plain(s, y, g, w, u, h_diag, full),
            lambda: torch.matmul(coef, x),
        ),
    }
    rows = {
        "fused_gram_projections": dict(
            bytes=(2 * M * n + n) * 4 * K,
            flops=2 * (2 * M * M + 2 * M) * n * K,
            max_abs_err=max(float((a - b).abs().max()) for a, b in zip(gram_full, gram_full_ref)),
        ),
        "fused_direction_assembly": dict(
            bytes=(2 * M * n + 2 * n) * 4 * K,
            flops=(4 * M + 3) * n * K,
            max_abs_err=float((asm_full - asm_full_ref).abs().max()),
        ),
    }
    for name, r in rows.items():
        for key, fn in zip(("ms", "plain_ms", "library_ms"), calls[name]):
            r[key], r[key.replace("ms", "device_ms")] = time_ms(fn, iters)
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / F32_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(
            f"timing {name} N={n} K={K} m={M} ms={r['ms']:.6f} device_ms={r['device_ms']:.6f} "
            f"plain_ms={r['plain_ms']:.6f} plain_device_ms={r['plain_device_ms']:.6f} "
            f"library_ms={r['library_ms']:.6f} library_device_ms={r['library_device_ms']:.6f} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']})",
            flush=True,
        )
    return rows


def gram_one_launch(call, r: dict) -> None:
    """The gram's device kernels in one call, from the profiler: exactly one
    launch; beside it the kernel's registers (build log) and its device
    time against its bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from federated_pytorch_test_tpu_torch.ops import build

    call()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session that records no device event at all (CUPTI missed it) is taken again
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = Counter(e.name for e in prof.events()
                          if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
        if kernels:
            break
    regs = [line for fn, line in ptxas_lines(build.build("compact_direction")) if "gram_kernel" in fn and "Used" in line]
    print(f"gram launches_per_call={sum(kernels.values())} kernels={dict(kernels)} ptxas={regs} "
          f"device_ms={r['device_ms']:.6f} bound_ms={r['bound_ms']:.6f} share_of_bound={r['bound_ms'] / r['device_ms']:.3f}",
          flush=True)
    if sum(kernels.values()) != 1 or "gram_kernel" not in next(iter(kernels)):
        fail(f"fused_gram_projections: expected one gram_kernel launch a call, the profiler saw {dict(kernels)}")


def flash_inputs(bh: int, s: int, d: int, seed: int):
    """Seeded q, k, v, dO `[BH, S, D]` f32 on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, s, d, device="cuda", generator=gen) for _ in range(4)]


def flash_check(bh: int, s: int, d: int, seed: int, f64: bool = False, label: str = "flash") -> dict:
    """Each flash kernel against its plain version at one shape; the errors.
    With `f64`, the kernels' gradients and the f32 plain version's are also
    read against the plain version in float64 (printed, not gated)."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    q, k, v, do = flash_inputs(bh, s, d, seed)
    scale = 1.0 / d ** 0.5
    o, lse = fc.flash_fwd(q, k, v, scale)
    o_ref, lse_ref = fc.flash_fwd_plain(q, k, v, scale)
    delta = (do * o_ref).sum(-1)
    dq = fc.flash_bwd_dq(q, k, v, do, lse_ref, delta, scale)
    dk, dv = fc.flash_bwd_dkv(q, k, v, do, lse_ref, delta, scale)
    dq_ref = fc.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, scale)
    dk_ref, dv_ref = fc.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, scale)
    torch.cuda.synchronize()
    pairs = {"o": (o, o_ref), "lse": (lse, lse_ref), "dq": (dq, dq_ref), "dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    errs = {name: rel_err(a, b) for name, (a, b) in pairs.items()}
    abs_errs = {name: float((a - b).abs().max()) for name, (a, b) in pairs.items()}
    finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs.values())
    vs_f64 = ""
    if f64:
        args64 = [t.double() for t in (q, k, v, do, lse_ref, delta)]
        ref64 = (fc.flash_bwd_dq_plain(*args64, scale), *fc.flash_bwd_dkv_plain(*args64, scale))
        for side, i in (("kernel", 0), ("plain_f32", 1)):
            vs_f64 += f" {side}_vs_f64 " + " ".join(f"{n}={rel_err(pairs[n][i].double(), r):.3e}"
                                                     for n, r in zip(("dq", "dk", "dv"), ref64))
        del args64, ref64
    print(f"{label} BH={bh} S={s} D={d} " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" finite={finite}"
          + vs_f64, flush=True)
    worst_fwd = max(errs["o"], errs["lse"])
    worst_bwd = max(errs["dq"], errs["dk"], errs["dv"])
    if not finite or not worst_fwd <= RTOL or not worst_bwd <= FLASH_GRAD_RTOL:
        fail(f"flash kernel disagrees with its plain version at BH={bh} S={s} D={d}: {errs} (finite={finite})")
    return abs_errs


def fwd_extra_checks(label: str, kernel, plain, qkv, scale: float, *mode) -> None:
    """Two more checks of a forward kernel at a path shape: two launches give
    the same bits; and q, k x 8 (scores x 64), where f32 rounding of the
    scores alone moves o by ~1e-5 of its largest entry. There the kernel and
    the plain version in f32 are both held against the plain version in
    float64: the kernel within RTOL of it, or no further from it than
    LARGE_SLACK times the f32 plain version is."""
    import torch

    q, k, v = qkv
    runs = [kernel(q, k, v, scale, *mode) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(*runs))
    print(f"flash repeat {label} bitwise_equal={same}", flush=True)
    if not same:
        fail(f"{label}: two launches on the same inputs differ")

    q8, k8 = 8 * q, 8 * k
    o, lse = kernel(q8, k8, v, scale, *mode)
    o32, lse32 = plain(q8, k8, v, scale, *mode)
    o64, lse64 = plain(q8.double(), k8.double(), v.double(), scale, *mode)
    torch.cuda.synchronize()
    errs = {"o": rel_err(o.double(), o64), "lse": rel_err(lse.double(), lse64)}
    plain_errs = {"o": rel_err(o32.double(), o64), "lse": rel_err(lse32.double(), lse64)}
    vs_plain = {"o": rel_err(o, o32), "lse": rel_err(lse, lse32)}
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    print(f"flash large {label} x8 kernel_vs_f64 o={errs['o']:.3e} lse={errs['lse']:.3e} "
          f"plain_f32_vs_f64 o={plain_errs['o']:.3e} lse={plain_errs['lse']:.3e} "
          f"kernel_vs_plain_f32 o={vs_plain['o']:.3e} lse={vs_plain['lse']:.3e} finite={finite}", flush=True)
    for name in errs:
        if not finite or not errs[name] <= max(RTOL, LARGE_SLACK * plain_errs[name]):
            fail(f"{label} x8: {name} is {errs[name]:.3e} from float64 (the f32 plain version: "
                 f"{plain_errs[name]:.3e}; finite={finite})")


def bwd_extra_checks(label: str, inputs, scale: float, mode=(), aligned: bool = False) -> None:
    """`fwd_extra_checks`' two checks for a pair of backward kernels at a path
    shape, from the plain forward's lse and delta: the rectangular pair in
    `mode` (causal, q_off, k_off), or the aligned causal pair. Two launches
    give the same bits; and with q, k x 8, dq, dk and dv within
    FLASH_GRAD_RTOL of the plain version in float64, or no further from it
    than LARGE_SLACK times the f32 plain version is."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    q, k, v, do = inputs
    if aligned:
        kernels = (fc.flash_bwd_dq, fc.flash_bwd_dkv)
        plains = (fc.flash_bwd_dq_plain, fc.flash_bwd_dkv_plain)
        fwd_plain = fc.flash_fwd_plain
    else:
        kernels = (fc.flash_bwd_dq_rect, fc.flash_bwd_dkv_rect)
        plains = (fc.flash_bwd_dq_rect_plain, fc.flash_bwd_dkv_rect_plain)
        fwd_plain = fc.flash_fwd_rect_plain

    def grads(fns, q, k, v, do, lse, delta):
        return (fns[0](q, k, v, do, lse, delta, scale, *mode), *fns[1](q, k, v, do, lse, delta, scale, *mode))

    def stats(q, k):
        o, lse = fwd_plain(q, k, v, scale, *mode)
        return lse, (do * o).sum(-1)

    lse, delta = stats(q, k)
    runs = [grads(kernels, q, k, v, do, lse, delta) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(*runs))
    print(f"flash repeat {label} bitwise_equal={same}", flush=True)
    if not same:
        fail(f"{label}: two launches on the same inputs differ")
    del runs

    q8, k8 = 8 * q, 8 * k
    lse, delta = stats(q8, k8)
    got = grads(kernels, q8, k8, v, do, lse, delta)
    f32 = grads(plains, q8, k8, v, do, lse, delta)
    f64 = grads(plains, *(t.double() for t in (q8, k8, v, do, lse, delta)))
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    errs = {n: rel_err(a.double(), ref) for n, a, ref in zip(names, got, f64)}
    plain_errs = {n: rel_err(b.double(), ref) for n, b, ref in zip(names, f32, f64)}
    vs_plain = {n: rel_err(a, b) for n, a, b in zip(names, got, f32)}
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    print(f"flash large {label} x8 kernel_vs_f64 " + " ".join(f"{n}={errs[n]:.3e}" for n in names)
          + " plain_f32_vs_f64 " + " ".join(f"{n}={plain_errs[n]:.3e}" for n in names)
          + " kernel_vs_plain_f32 " + " ".join(f"{n}={vs_plain[n]:.3e}" for n in names) + f" finite={finite}",
          flush=True)
    for n in names:
        if not finite or not errs[n] <= max(FLASH_GRAD_RTOL, LARGE_SLACK * plain_errs[n]):
            fail(f"{label} x8: {n} is {errs[n]:.3e} from float64 (the f32 plain version: "
                 f"{plain_errs[n]:.3e}; finite={finite})")


def add_shape(reports: dict, rows: dict, label: str) -> None:
    """Timing rows of one path shape into `reports`: the first shape's row
    leads (the kernel JSON's numbers), every shape's device times ride along
    under `shapes`."""
    for name, r in rows.items():
        r.setdefault("shape", label)
        reports.setdefault(name, r)
        reports[name].setdefault("shapes", {})[label] = {key: r[key] for key in (
            "device_ms", "ms", "plain_device_ms", "library_device_ms", "bound_ms", "bound_term")}


def phase_flash():
    """The flash kernels against their plain versions at every shape; timings
    at the LM paths' shapes (D 16, and D 128 at dim 512); a padded head dim
    through the public op."""
    for d in FLASH_DIMS:
        for s in FLASH_SEQS:
            flash_check(FLASH_SWEEP_BH, s, d, seed=s + d, f64=s >= FLASH_PATH[1])
    for d in FLASH_DIMS:  # twice the LM's sequence: the gradients sum over twice the tiles
        flash_check(FLASH_SWEEP_BH, FLASH_HEADROOM_S, d, seed=FLASH_HEADROOM_S + d, f64=True, label="flash headroom")
    reports = {}
    for bh, s, d in (FLASH_PATH, LM128_PATH):
        add_shape(reports, time_causal(bh, s, d), f"BH={bh} S={s} D={d} causal")
    padded_check("highest", True)
    return reports


def time_causal(bh: int, s: int, d: int) -> dict:
    """At one path shape of the aligned causal kernels: the check against
    the plain version (and float64), the repeat and x8 checks, then the
    times beside the bounds and SDPA."""
    import torch
    import torch.nn.functional as F

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    abs_errs = flash_check(bh, s, d, seed=1, f64=True)
    tag = "" if d == FLASH_PATH[2] else f" D={d}"
    fwd_extra_checks("flash_fwd" + tag, fc.flash_fwd, fc.flash_fwd_plain, flash_inputs(bh, s, d, seed=5)[:3],
                     1.0 / d ** 0.5)
    bwd_extra_checks("flash_bwd" + tag, flash_inputs(bh, s, d, seed=7), 1.0 / d ** 0.5, aligned=True)

    q, k, v, do = flash_inputs(bh, s, d, seed=1)
    scale = 1.0 / d ** 0.5
    o, lse = fc.flash_fwd_plain(q, k, v, scale)
    delta = (do * o).sum(-1)
    # the yardstick: one PyTorch call computing the same function, [1, BH, S, D]
    q4, k4, v4 = (t.detach().view(1, bh, s, d).requires_grad_(True) for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.view(1, bh, s, d)

    def sdpa_bwd():
        torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

    calls = {
        "flash_fwd": (
            lambda: fc.flash_fwd(q, k, v, scale),
            lambda: fc.flash_fwd_plain(q, k, v, scale),
            lambda: F.scaled_dot_product_attention(q4.detach(), k4.detach(), v4.detach(), is_causal=True),
        ),
        "flash_bwd_dq": (
            lambda: fc.flash_bwd_dq(q, k, v, do, lse, delta, scale),
            lambda: fc.flash_bwd_dq_plain(q, k, v, do, lse, delta, scale),
            sdpa_bwd,
        ),
        "flash_bwd_dkv": (
            lambda: fc.flash_bwd_dkv(q, k, v, do, lse, delta, scale),
            lambda: fc.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale),
            sdpa_bwd,
        ),
    }
    pairs = bh * s * (s + 1) // 2  # (query, key) pairs under the causal mask
    operand = bh * s * d * 4  # bytes of one [BH, S, D] f32 tensor
    row = bh * s * 4  # bytes of one [BH, S] f32 tensor
    work = {  # (bytes: each input read once, each output written once; flops: 2·D per pair per product; exps)
        "flash_fwd": (3 * operand + operand + row, 2 * 2 * d * pairs, pairs),
        "flash_bwd_dq": (4 * operand + 2 * row + operand, 3 * 2 * d * pairs, pairs),
        "flash_bwd_dkv": (4 * operand + 2 * row + 2 * operand, 4 * 2 * d * pairs, pairs),
    }
    abs_of = {"flash_fwd": max(abs_errs["o"], abs_errs["lse"]), "flash_bwd_dq": abs_errs["dq"],
              "flash_bwd_dkv": max(abs_errs["dk"], abs_errs["dv"])}
    # the whole causal attention, forward then backward, through autograd
    q3, k3, v3 = (t.detach().requires_grad_(True) for t in (q, k, v))

    def flash_fwd_bwd():
        torch.autograd.grad(fc._FlashCausal.apply(q3, k3, v3, scale), (q3, k3, v3), do)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), (q4, k4, v4), do4)

    return time_flash(f"BH={bh} S={s} D={d}", calls, work, abs_of, flash_fwd_bwd, sdpa_fwd_bwd)


def time_flash(label: str, calls: dict, work: dict, abs_of: dict, fwd_bwd, sdpa_fwd_bwd,
               products: str = "tf32x3", plain_queued: int = QUEUED_CALLS) -> dict:
    """Times of each flash kernel, its plain version and the library call,
    beside the bound from (bytes, flops) with the products at `products`
    (`flash_bounds`); then the whole attention forward and backward through
    autograd against the library's. `plain_queued` calls of a plain version
    are queued for its device time; 0 times it as issued only (a
    tile-by-tile plain version launches more kernels a call than the
    launch queue holds), and its device reading is then that one."""
    both = [time_ms(fn, 20) for fn in (fwd_bwd, sdpa_fwd_bwd)]
    print(f"timing fwd+bwd {label} flash_ms={both[0][0]:.6f} flash_device_ms={both[0][1]:.6f} "
          f"library_ms={both[1][0]:.6f} library_device_ms={both[1][1]:.6f}", flush=True)

    report = {}
    for name, fns in calls.items():
        n_bytes, flops, exps = work[name]
        r = {"bytes": n_bytes, "flops": flops, "exps": exps, "max_abs_err": abs_of[name]}
        for key, fn in zip(("ms", "plain_ms", "library_ms"), fns):
            r[key], r[key.replace("ms", "device_ms")] = time_ms(fn, 20, plain_queued if key == "plain_ms"
                                                                else QUEUED_CALLS)
        r.update(flash_bounds(n_bytes, flops, exps, products))
        print(
            f"timing {name} {label} ms={r['ms']:.6f} device_ms={r['device_ms']:.6f} "
            f"plain_ms={r['plain_ms']:.6f} plain_device_ms={r['plain_device_ms']:.6f} "
            f"library_ms={r['library_ms']:.6f} library_device_ms={r['library_device_ms']:.6f} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}: {r['bound_term']}) "
            f"ffma_bound_ms={r['ffma_bound_ms']:.6f} gflop={flops / 1e9:.3f} "
            f"achieved_tflops={flops / r['device_ms'] / 1e9:.3f} share_of_bound={r['bound_ms'] / r['device_ms']:.3f}",
            flush=True,
        )
        report[name] = r
    return report


PRODUCT_SECONDS = {  # seconds a flop of the products takes on the tensor cores, by arithmetic
    "tf32x3": 3 / TF32_FLOPS,  # split TF32: three products ('highest')
    "tf32x1": 1 / TF32_FLOPS,  # one TF32 product ('default' on f32 inputs)
    "bf16": 1 / BF16_FLOPS,  # bf16 products (the cast16 trio)
}


def flash_bounds(n_bytes: int, flops: int, exps: int, products: str = "tf32x3") -> dict:
    """The least time of a flash kernel on the card: the largest of its
    bytes at the memory rate, its products at the tensor-core rate of their
    arithmetic (`PRODUCT_SECONDS`), and its exps at the SFU rate; and,
    beside it, the ceiling of an f32 FFMA design (flops at 67 TFLOP/s or the
    bytes)."""
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3, products: flops * PRODUCT_SECONDS[products] * 1e3,
             "exp": exps / EXPS_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "ffma_bound_ms": max(terms["bytes"], flops / F32_FLOPS * 1e3)}


PADDED_SHAPE = (2, 1024, 4)  # (B, S, H) of the padded head dim's checks
PADDED = {}  # the padding's price by family: the public op's fwd+bwd device ms at PADDED_D and at 128


def padded_check(family: str, causal: bool) -> None:
    """The public op (`flash_attention`) at a head dim between instances,
    PADDED_D, on the card: it pads q, k, v up to the D-128 instance and
    slices the padding off. Held against the plain versions at the true D
    (o and the cotangents, at the family's tolerance: 'highest' RTOL and
    FLASH_GRAD_RTOL, 'default' ONE_PASS_RTOL, 'bf16' BF16_UNITS), each
    kernel of the family launched once; then its forward and backward
    timed beside the same op at D 128, the padding's price."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    b, s, h = PADDED_SHAPE
    d = PADDED_D
    gen = torch.Generator(device="cuda").manual_seed(d + causal)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen) for _ in range(4))
    dtype = torch.bfloat16 if family == "bf16" else torch.float32
    precision = "highest" if family == "highest" else "default"
    kernels = fc.BF16_KERNELS if family == "bf16" else fc.CAUSAL_KERNELS if causal else fc.RECT_KERNELS
    if family == "default":
        kernels = tuple(fc.ONE_PASS[n] for n in kernels)
    leaves = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]

    def op():
        out = fc.flash_attention(*leaves, causal=causal, precision=precision)
        return out, torch.autograd.grad(out, leaves, do.to(out.dtype))

    torch.cuda.synchronize()
    fc.reset_launch_counts()
    out, grads = op()
    torch.cuda.synchronize()
    launched = {n: c for n, c in fc.LAUNCHES.items() if c}

    scale = 1.0 / d ** 0.5
    q3, k3, v3 = (fc._to3(t, dtype) for t in (q, k, v))
    if family == "bf16":
        qs = fc.prescale_q(q3, scale)
        do3 = fc._to3(do.to(torch.bfloat16).float())
        o, lse = fc.flash_fwd_bf16_plain(qs, k3, v3)
        delta = (do3 * o).sum(-1)
        do16 = do3.to(torch.bfloat16)
        ref = (o, fc.flash_bwd_dq_bf16_plain(qs, k3, v3, do16, lse, delta, scale),
               *fc.flash_bwd_dkv_bf16_plain(qs, k3, v3, do16, lse, delta))
    else:
        do3 = fc._to3(do)
        mode = () if causal else (False, 0, 0)
        if family == "default":
            plains = (fc.flash_fwd_1pass_plain, fc.flash_bwd_dq_1pass_plain, fc.flash_bwd_dkv_1pass_plain)
            mode = (causal, 0, 0)
        elif causal:
            plains = (fc.flash_fwd_plain, fc.flash_bwd_dq_plain, fc.flash_bwd_dkv_plain)
        else:
            plains = (fc.flash_fwd_rect_plain, fc.flash_bwd_dq_rect_plain, fc.flash_bwd_dkv_rect_plain)
        o, lse = plains[0](q3, k3, v3, scale, *mode)
        delta = (do3 * o).sum(-1)
        ref = (o, plains[1](q3, k3, v3, do3, lse, delta, scale, *mode), *plains[2](q3, k3, v3, do3, lse, delta, scale, *mode))
    got = [fc._to3(t, t.dtype) for t in (out.detach(), *grads)]
    names = ("o", "dq", "dk", "dv")
    if family == "bf16":
        errs = {n: bf16_units(a, b) for n, a, b in zip(names, got, ref)}
        ok = max(errs.values()) <= BF16_UNITS
    else:
        errs = {n: rel_err(a, b) for n, a, b in zip(names, got, ref)}
        tol = {"o": RTOL} if family == "highest" else {}
        ok = all(e <= tol.get(n, FLASH_GRAD_RTOL if family == "highest" else ONE_PASS_RTOL) for n, e in errs.items())
    finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
    shapes = out.shape == q.shape and all(g.shape == q.shape for g in grads)
    label = f"flash padded {family} {'causal' if causal else 'non-causal'} D={d}->{fc.padded_dim(d)} B={b} S={s} H={h}"
    print(f"{label} " + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
          + f" finite={finite} shapes={shapes} launches={json.dumps(launched)}", flush=True)
    if not ok or not finite or not shapes:
        fail(f"{label}: the padded op disagrees with the plain versions at the true D: {errs} (finite={finite})")
    gate_launches(label, launched, {**{n: 1 for n in kernels}, **{n: 0 for n in launched if n not in kernels}})

    wide = [t.to(dtype).requires_grad_(True) for t in (torch.randn(b, s, h, 128, device="cuda", generator=gen)
                                                        for _ in range(3))]
    do_wide = torch.randn(b, s, h, 128, device="cuda", generator=gen)

    def op_wide():
        out = fc.flash_attention(*wide, causal=causal, precision=precision)
        torch.autograd.grad(out, wide, do_wide.to(out.dtype))

    t_pad, t_wide = time_ms(op, 10), time_ms(op_wide, 10)
    PADDED[f"{family} {'causal' if causal else 'non-causal'}"] = {"d": d, "device_ms": t_pad[1],
                                                                   "d128_device_ms": t_wide[1]}
    print(f"timing padded {label} fwd+bwd ms={t_pad[0]:.6f} device_ms={t_pad[1]:.6f} at D=128: ms={t_wide[0]:.6f} "
          f"device_ms={t_wide[1]:.6f} price_device={t_pad[1] / t_wide[1]:.3f}x", flush=True)


def rect_inputs(bh: int, s_q: int, s_kv: int, d: int, seed: int):
    """Seeded q, k, v, dO f32 on the card: q and dO `[BH, Sq, D]`, k and v `[BH, Skv, D]`."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, n, d, device="cuda", generator=gen) for n in (s_q, s_kv, s_kv, s_q)]


def rect_check(bh: int, s_q: int, s_kv: int, d: int, causal: bool, q_off: int, k_off: int, seed: int,
               f64: bool = False) -> dict:
    """Each rectangular kernel against its plain version at one shape and
    offset; rows that see no key must be exact. With `f64`, the kernels'
    gradients and the f32 plain version's are also read against the plain
    version in float64 (printed, not gated). Returns the absolute errors."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    q, k, v, do = rect_inputs(bh, s_q, s_kv, d, seed)
    scale = 1.0 / d ** 0.5
    args = (scale, causal, q_off, k_off)
    o, lse = fc.flash_fwd_rect(q, k, v, *args)
    o_ref, lse_ref = fc.flash_fwd_rect_plain(q, k, v, *args)
    delta = (do * o_ref).sum(-1)
    dq = fc.flash_bwd_dq_rect(q, k, v, do, lse_ref, delta, *args)
    dk, dv = fc.flash_bwd_dkv_rect(q, k, v, do, lse_ref, delta, *args)
    dq_ref = fc.flash_bwd_dq_rect_plain(q, k, v, do, lse_ref, delta, *args)
    dk_ref, dv_ref = fc.flash_bwd_dkv_rect_plain(q, k, v, do, lse_ref, delta, *args)
    torch.cuda.synchronize()
    live = fc._rect_keep(s_q, s_kv, q_off, k_off, q.device).any(-1) if causal else torch.ones(
        s_q, dtype=torch.bool, device=q.device)
    pairs = {"o": (o, o_ref), "lse": (lse[:, live], lse_ref[:, live]), "dq": (dq, dq_ref), "dk": (dk, dk_ref),
             "dv": (dv, dv_ref)}
    errs = {name: rel_err(a, b) if a.numel() else 0.0 for name, (a, b) in pairs.items()}
    abs_errs = {name: float((a - b).abs().max()) if a.numel() else 0.0 for name, (a, b) in pairs.items()}
    finite = all(bool(torch.isfinite(a).all()) for a in (o, lse, dq, dk, dv))
    dead = ~live
    exact = bool((o[:, dead] == 0).all() and (lse[:, dead] == -1e30).all() and (dq[:, dead] == 0).all())
    mode = f"causal q_off={q_off} k_off={k_off}" if causal else "non-causal"
    vs_f64 = ""
    if f64:
        args64 = [t.double() for t in (q, k, v, do, lse_ref, delta)]
        ref64 = (fc.flash_bwd_dq_rect_plain(*args64, *args), *fc.flash_bwd_dkv_rect_plain(*args64, *args))
        for side, i in (("kernel", 0), ("plain_f32", 1)):
            vs_f64 += f" {side}_vs_f64 " + " ".join(f"{n}={rel_err(pairs[n][i].double(), r):.3e}"
                                                     for n, r in zip(("dq", "dk", "dv"), ref64))
        del args64, ref64
    print(f"flash rect BH={bh} Sq={s_q} Skv={s_kv} D={d} {mode} dead_rows={int(dead.sum())} "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" finite={finite} dead_rows_exact={exact}" + vs_f64,
          flush=True)
    worst_fwd = max(errs["o"], errs["lse"])
    worst_bwd = max(errs["dq"], errs["dk"], errs["dv"])
    if not finite or not exact or not worst_fwd <= RTOL or not worst_bwd <= FLASH_GRAD_RTOL:
        fail(f"rect flash kernel disagrees with its plain version at BH={bh} Sq={s_q} Skv={s_kv} D={d} {mode}: "
             f"{errs} (finite={finite}, dead rows exact={exact})")
    return abs_errs


def block_autograd_check(s_q: int, s_kv: int, causal: bool, q_off: int, k_off: int) -> None:
    """`flash_block`'s autograd (the kernels, dlse folded into delta) against
    autograd through the plain forward, with non-zero o and lse cotangents."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    b, h, d = 2, 4, 16
    gen = torch.Generator(device="cuda").manual_seed(s_q + s_kv + q_off + k_off)
    q = torch.randn(b, s_q, h, d, device="cuda", generator=gen)
    k, v = (torch.randn(b, s_kv, h, d, device="cuda", generator=gen) for _ in range(2))
    do = torch.randn(b, h, s_q, d, device="cuda", generator=gen)
    dlse = torch.randn(b, h, s_q, device="cuda", generator=gen)

    def plain_block(q, k, v):
        o, lse = fc.flash_fwd_rect_plain(fc._to3(q), fc._to3(k), fc._to3(v), 1.0 / d ** 0.5, causal, q_off, k_off)
        return o.reshape(b, h, s_q, d), lse.reshape(b, h, s_q)

    grads = []
    for fn in (lambda q, k, v: fc.flash_block(q, k, v, q_off, k_off, causal=causal), plain_block):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o, lse = fn(*leaves)
        grads.append(torch.autograd.grad((o * do).sum() + (lse * dlse).sum(), leaves))
    errs = {f"d{n}": rel_err(a, b) for n, a, b in zip("qkv", *grads)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads[0])
    mode = f"causal q_off={q_off} k_off={k_off}" if causal else "non-causal"
    print(f"flash_block autograd Sq={s_q} Skv={s_kv} {mode} " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f" finite={finite}", flush=True)
    if not finite or not max(errs.values()) <= FLASH_GRAD_RTOL:
        fail(f"flash_block gradients disagree with plain autograd ({mode}): {errs}")


def phase_flash_rect():
    """The rectangular flash kernels against their plain versions, both modes;
    `flash_block`'s autograd; timings at the ViT paths' shapes (D 16, and D
    128 at dim 256); a padded head dim through the public op."""
    for d in FLASH_DIMS:
        for s in (*RECT_SEQS, *((2048,) if d == 128 else ())):  # S 2048 at D 128, also against float64
            rect_check(FLASH_SWEEP_BH, s, s, d, False, 0, 0, seed=3 * s + d, f64=s == 2048)
        for s_q, s_kv, q_off, k_off in RECT_OFFSETS:
            rect_check(FLASH_SWEEP_BH, s_q, s_kv, d, True, q_off, k_off, seed=s_q + s_kv + q_off + k_off + d)
    for s_q, s_kv, causal, q_off, k_off in ((256, 256, False, 0, 0), (256, 256, True, 0, 64), (128, 384, True, 256, 64)):
        block_autograd_check(s_q, s_kv, causal, q_off, k_off)
    reports = {}
    for bh, s, d in (RECT_PATH, VIT128_PATH):
        add_shape(reports, time_rect(bh, s, d), f"BH={bh} S={s} D={d} non-causal")
    padded_check("highest", False)
    return reports


def time_rect(bh: int, s: int, d: int) -> dict:
    """At one path shape of the rectangular kernels: the check against the
    plain version, the repeat and x8 checks (non-causal and causal at
    q_off 64), then the times beside the bounds and SDPA."""
    import torch
    import torch.nn.functional as F

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    abs_errs = rect_check(bh, s, s, d, False, 0, 0, seed=2)
    inputs = rect_inputs(bh, s, s, d, seed=6)
    qkv = inputs[:3]
    tag = "" if d == RECT_PATH[2] else f" D={d}"
    fwd_extra_checks("flash_fwd_rect" + tag, fc.flash_fwd_rect, fc.flash_fwd_rect_plain, qkv, 1.0 / d ** 0.5)
    fwd_extra_checks(f"flash_fwd_rect{tag} causal q_off=64 k_off=0", fc.flash_fwd_rect, fc.flash_fwd_rect_plain, qkv,
                     1.0 / d ** 0.5, True, 64, 0)
    bwd_extra_checks("flash_bwd_rect" + tag, inputs, 1.0 / d ** 0.5)
    bwd_extra_checks(f"flash_bwd_rect{tag} causal q_off=64 k_off=0", inputs, 1.0 / d ** 0.5, (True, 64, 0))
    del inputs, qkv

    q, k, v, do = rect_inputs(bh, s, s, d, seed=2)
    scale = 1.0 / d ** 0.5
    o, lse = fc.flash_fwd_rect_plain(q, k, v, scale)
    delta = (do * o).sum(-1)
    q4, k4, v4 = (t.detach().view(1, bh, s, d).requires_grad_(True) for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4)
    do4 = do.view(1, bh, s, d)

    def sdpa_bwd():
        torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

    calls = {
        "flash_fwd_rect": (
            lambda: fc.flash_fwd_rect(q, k, v, scale),
            lambda: fc.flash_fwd_rect_plain(q, k, v, scale),
            lambda: F.scaled_dot_product_attention(q4.detach(), k4.detach(), v4.detach()),
        ),
        "flash_bwd_dq_rect": (
            lambda: fc.flash_bwd_dq_rect(q, k, v, do, lse, delta, scale),
            lambda: fc.flash_bwd_dq_rect_plain(q, k, v, do, lse, delta, scale),
            sdpa_bwd,
        ),
        "flash_bwd_dkv_rect": (
            lambda: fc.flash_bwd_dkv_rect(q, k, v, do, lse, delta, scale),
            lambda: fc.flash_bwd_dkv_rect_plain(q, k, v, do, lse, delta, scale),
            sdpa_bwd,
        ),
    }
    pairs = bh * s * s  # non-causal: every (query, key) pair
    operand = bh * s * d * 4
    row = bh * s * 4
    work = {
        "flash_fwd_rect": (3 * operand + operand + row, 2 * 2 * d * pairs, pairs),
        "flash_bwd_dq_rect": (4 * operand + 2 * row + operand, 3 * 2 * d * pairs, pairs),
        "flash_bwd_dkv_rect": (4 * operand + 2 * row + 2 * operand, 4 * 2 * d * pairs, pairs),
    }
    abs_of = {"flash_fwd_rect": max(abs_errs["o"], abs_errs["lse"]), "flash_bwd_dq_rect": abs_errs["dq"],
              "flash_bwd_dkv_rect": max(abs_errs["dk"], abs_errs["dv"])}
    q3, k3, v3 = (t.detach().requires_grad_(True) for t in (q, k, v))

    def flash_fwd_bwd():
        torch.autograd.grad(fc._FlashRect.apply(q3, k3, v3, scale, False, 0, 0)[0], (q3, k3, v3), do)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), do4)

    return time_flash(f"BH={bh} S={s} D={d} non-causal", calls, work, abs_of, flash_fwd_bwd, sdpa_fwd_bwd)


ONE_PASS_RTOL = 2.0 ** -10  # every output of a one-pass kernel from its plain version: one TF32 unit (`onepass_check`)
ONE_PASS_SPREAD = 4.0  # the kernel's RMS distance to 'highest' over its RMS distance to its plain version, at least
DEFAULT_F64_TOL = 2e-2  # the JAX package's 'default' contract against f32 (tests/test_flash.py:127-134)
BF16_UNITS = 2  # bf16 outputs from their plain version, in bf16 units of the largest entry (`bf16_units`)
BF16_PATHS = ((128, 2048, 16), (32, 4096, 64), LM128_PATH)  # (BH, S, D): the LM's, a longer, wider head, the LM's at D 128
BF16_REPLACES = {
    "flash_fwd_bf16": "federated_pytorch_test_tpu/ops/flash_attention.py:559",
    "flash_bwd_dq_bf16": "federated_pytorch_test_tpu/ops/flash_attention.py:655",
    "flash_bwd_dkv_bf16": "federated_pytorch_test_tpu/ops/flash_attention.py:673",
}


def onepass_check(bh: int, s_q: int, s_kv: int, d: int, aligned: bool, causal: bool = True, q_off: int = 0,
                  k_off: int = 0, seed: int = 0, f64: bool = False) -> dict:
    """The one-pass ('default') kernels of a family against their plain
    versions at one shape: the aligned causal trio, or the rectangular one
    in `causal`, `q_off`, `k_off`.

    The plain versions round every operand as the kernels do, but sum the
    scores in another order and take 2^x by another routine, so where a
    probability (or dS) sits at a TF32 rounding boundary the two round it
    one unit apart, a relative 2^-10 of that entry. One such entry moves an
    output by at most 2^-10 of the largest term it enters, so every output
    is held within ONE_PASS_RTOL (2^-10) of its largest entry. The rest is
    summation order, orders of magnitude below; so the kernel must also sit
    ONE_PASS_SPREAD times closer, in root-mean-square distance, to its plain
    version than to the 'highest' plain version: it makes the one-pass
    roundings, all of them. With `f64`, also within the JAX package's
    'default' bound of float64 (DEFAULT_F64_TOL of the largest entry).
    Returns the absolute errors."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    q, k, v, do = rect_inputs(bh, s_q, s_kv, d, seed)
    scale = 1.0 / d ** 0.5
    if aligned:
        mode = ()
        kern = (fc.flash_fwd, fc.flash_bwd_dq, fc.flash_bwd_dkv)
        high = (fc.flash_fwd_plain, fc.flash_bwd_dq_plain, fc.flash_bwd_dkv_plain)
        one = (fc.flash_fwd_1pass_plain, fc.flash_bwd_dq_1pass_plain, fc.flash_bwd_dkv_1pass_plain)
        label = f"flash default BH={bh} S={s_q} D={d} causal"
    else:
        mode = (causal, q_off, k_off)
        kern = (fc.flash_fwd_rect, fc.flash_bwd_dq_rect, fc.flash_bwd_dkv_rect)
        high = (fc.flash_fwd_rect_plain, fc.flash_bwd_dq_rect_plain, fc.flash_bwd_dkv_rect_plain)
        one = (fc.flash_fwd_1pass_plain, fc.flash_bwd_dq_1pass_plain, fc.flash_bwd_dkv_1pass_plain)
        label = (f"flash default rect BH={bh} Sq={s_q} Skv={s_kv} D={d} "
                 + (f"causal q_off={q_off} k_off={k_off}" if causal else "non-causal"))
    one_mode = mode if not aligned else (True, 0, 0)
    o, lse = kern[0](q, k, v, scale, *mode, precision="default")
    o_one, lse_one = one[0](q, k, v, scale, *one_mode)
    o_hi, lse_hi = high[0](q, k, v, scale, *mode)
    delta = (do * o_one).sum(-1)
    grads = (kern[1](q, k, v, do, lse_one, delta, scale, *mode, precision="default"),
             *kern[2](q, k, v, do, lse_one, delta, scale, *mode, precision="default"))
    grads_one = (one[1](q, k, v, do, lse_one, delta, scale, *one_mode),
                 *one[2](q, k, v, do, lse_one, delta, scale, *one_mode))
    grads_hi = (high[1](q, k, v, do, lse_one, delta, scale, *mode), *high[2](q, k, v, do, lse_one, delta, scale, *mode))
    torch.cuda.synchronize()
    live = torch.ones(s_q, dtype=torch.bool, device=q.device)
    if causal and not aligned:
        live = fc._rect_keep(s_q, s_kv, q_off, k_off, q.device).any(-1)
    names = ("o", "lse", "dq", "dk", "dv")
    got = (o, lse[:, live], *grads)
    ref_one = (o_one, lse_one[:, live], *grads_one)
    ref_hi = (o_hi, lse_hi[:, live], *grads_hi)
    errs = {n: rel_err(a, b) if a.numel() else 0.0 for n, a, b in zip(names, got, ref_one)}
    errs_hi = {n: rel_err(a, b) if a.numel() else 0.0 for n, a, b in zip(names, got, ref_hi)}

    def rms(a, b):
        return float((a - b).double().pow(2).mean().sqrt()) if a.numel() else 0.0

    spread = {n: rms(a, h) / max(rms(a, b), 1e-30) for n, a, b, h in zip(names, got, ref_one, ref_hi)}
    abs_errs = {n: float((a - b).abs().max()) if a.numel() else 0.0 for n, a, b in zip(names, got, ref_one)}
    finite = all(bool(torch.isfinite(a).all()) for a in (o, lse, *grads))
    dead_exact = True
    if not bool(live.all()):
        dead = ~live
        dead_exact = bool((o[:, dead] == 0).all() and (lse[:, dead] == -1e30).all() and (grads[0][:, dead] == 0).all())
    vs_f64 = {}
    if f64:
        args64 = [t.double() for t in (q, k, v)]
        o64, lse64 = high[0](*args64, scale, *mode)
        d64 = (do.double() * o64).sum(-1)
        g64 = (high[1](*args64, do.double(), lse64, d64, scale, *mode),
               *high[2](*args64, do.double(), lse64, d64, scale, *mode))
        vs_f64 = {n: rel_err(a.double(), b) for n, a, b in zip(names, (o, lse[:, live], *grads),
                                                             (o64, lse64[:, live], *g64))}
        del args64, o64, g64
    print(f"{label} " + " ".join(f"{n}={errs[n]:.3e}" for n in names)
          + " vs_highest " + " ".join(f"{n}={errs_hi[n]:.3e}" for n in names)
          + " rms_spread " + " ".join(f"{n}={spread[n]:.1f}" for n in names)
          + ("" if not vs_f64 else " vs_f64 " + " ".join(f"{n}={vs_f64[n]:.3e}" for n in names))
          + f" finite={finite} dead_rows_exact={dead_exact}", flush=True)
    if not finite or not dead_exact or not max(errs.values()) <= ONE_PASS_RTOL:
        fail(f"{label}: one-pass kernel disagrees with its plain version: {errs} (finite={finite}, "
             f"dead rows exact={dead_exact})")
    for n in ("o", "dq", "dk", "dv"):
        if spread[n] < ONE_PASS_SPREAD:
            fail(f"{label}: {n} sits nearly as close to 'highest' as to the one-pass plain version (RMS ratio "
                 f"{spread[n]:.2f}): the kernel does not make the one-pass roundings")
    if vs_f64 and not max(vs_f64.values()) <= DEFAULT_F64_TOL:
        fail(f"{label}: one-pass kernel strays past {DEFAULT_F64_TOL} from float64: {vs_f64}")
    return abs_errs


def repeat_check(label: str, fn) -> None:
    """Two calls of `fn` on the same inputs give the same bits."""
    import torch

    runs = [fn() for _ in range(2)]
    torch.cuda.synchronize()
    same = all(bitwise_equal(a, b) for a, b in zip(*runs))
    print(f"flash repeat {label} bitwise_equal={same}", flush=True)
    if not same:
        fail(f"{label}: two launches on the same inputs differ")


def phase_flash_default():
    """The six one-pass ('default') flash kernels against their plain
    versions (`onepass_check`) at every head dim and at the LM's and the
    ViT's shapes (also against float64); two launches equal bits at the
    path shapes; times there beside the bound (one TF32 product, the exps or
    the bytes) and `scaled_dot_product_attention` in f32."""
    import torch
    import torch.nn.functional as F

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    for d in FLASH_DIMS:
        onepass_check(FLASH_SWEEP_BH, 1024, 1024, d, aligned=True, seed=11 + d)
        onepass_check(FLASH_SWEEP_BH, 256, 256, d, aligned=False, causal=False, seed=13 + d)
        onepass_check(FLASH_SWEEP_BH, 256, 256, d, aligned=False, causal=True, q_off=0, k_off=64, seed=17 + d)
        onepass_check(FLASH_SWEEP_BH, 128, 384, d, aligned=False, causal=True, q_off=256, k_off=64, seed=19 + d)
    for s in (128, 256, 2048):  # D 128 at the other sequences, against float64 from S 2048
        onepass_check(FLASH_SWEEP_BH, s, s, 128, aligned=True, seed=11 + s, f64=s == 2048)
    padded_check("default", True)
    reports = {}
    for aligned, (bh, s, d) in ((True, FLASH_PATH), (False, RECT_PATH), (True, LM128_PATH), (False, VIT128_PATH)):
        abs_errs = onepass_check(bh, s, s, d, aligned=aligned, causal=aligned, seed=23, f64=True)
        q, k, v, do = flash_inputs(bh, s, d, seed=29)
        scale = 1.0 / d ** 0.5
        causal = aligned
        if aligned:
            fwd, dq_k, dkv_k = fc.flash_fwd, fc.flash_bwd_dq, fc.flash_bwd_dkv
            fwd_p, dq_p, dkv_p = fc.flash_fwd_1pass_plain, fc.flash_bwd_dq_1pass_plain, fc.flash_bwd_dkv_1pass_plain
            names = fc.CAUSAL_KERNELS
        else:
            fwd, dq_k, dkv_k = fc.flash_fwd_rect, fc.flash_bwd_dq_rect, fc.flash_bwd_dkv_rect
            names = fc.RECT_KERNELS

            def fwd_p(q, k, v, scale):
                return fc.flash_fwd_1pass_plain(q, k, v, scale, False)

            def dq_p(*a):
                return fc.flash_bwd_dq_1pass_plain(*a, False)

            def dkv_p(*a):
                return fc.flash_bwd_dkv_1pass_plain(*a, False)
        o, lse = fwd_p(q, k, v, scale)
        delta = (do * o).sum(-1)
        repeat_check(f"{names[0]} default D={d}", lambda: fwd(q, k, v, scale, precision="default"))
        repeat_check(f"{names[1]}+{names[2]} default D={d}",
                     lambda: (dq_k(q, k, v, do, lse, delta, scale, precision="default"),
                              *dkv_k(q, k, v, do, lse, delta, scale, precision="default")))
        q4, k4, v4 = (t.detach().view(1, bh, s, d).requires_grad_(True) for t in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        do4 = do.view(1, bh, s, d)

        def sdpa_bwd():
            torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

        calls = {
            fc.ONE_PASS[names[0]]: (
                lambda: fwd(q, k, v, scale, precision="default"),
                lambda: fwd_p(q, k, v, scale),
                lambda: F.scaled_dot_product_attention(q4.detach(), k4.detach(), v4.detach(), is_causal=causal),
            ),
            fc.ONE_PASS[names[1]]: (
                lambda: dq_k(q, k, v, do, lse, delta, scale, precision="default"),
                lambda: dq_p(q, k, v, do, lse, delta, scale),
                sdpa_bwd,
            ),
            fc.ONE_PASS[names[2]]: (
                lambda: dkv_k(q, k, v, do, lse, delta, scale, precision="default"),
                lambda: dkv_p(q, k, v, do, lse, delta, scale),
                sdpa_bwd,
            ),
        }
        pairs = bh * s * (s + 1) // 2 if causal else bh * s * s
        operand, row = bh * s * d * 4, bh * s * 4
        work = {
            fc.ONE_PASS[names[0]]: (3 * operand + operand + row, 2 * 2 * d * pairs, pairs),
            fc.ONE_PASS[names[1]]: (4 * operand + 2 * row + operand, 3 * 2 * d * pairs, pairs),
            fc.ONE_PASS[names[2]]: (4 * operand + 2 * row + 2 * operand, 4 * 2 * d * pairs, pairs),
        }
        abs_of = {fc.ONE_PASS[names[0]]: max(abs_errs["o"], abs_errs["lse"]), fc.ONE_PASS[names[1]]: abs_errs["dq"],
                  fc.ONE_PASS[names[2]]: max(abs_errs["dk"], abs_errs["dv"])}
        q3, k3, v3 = (t.detach().requires_grad_(True) for t in (q, k, v))

        def flash_fwd_bwd():
            if causal:
                out = fc._FlashCausal.apply(q3, k3, v3, scale, "default")
            else:
                out = fc._FlashRect.apply(q3, k3, v3, scale, False, 0, 0, "default")[0]
            torch.autograd.grad(out, (q3, k3, v3), do)

        def sdpa_fwd_bwd():
            torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal), (q4, k4, v4), do4)

        label = f"BH={bh} S={s} D={d} {'causal' if causal else 'non-causal'} default"
        add_shape(reports, time_flash(label, calls, work, abs_of, flash_fwd_bwd, sdpa_fwd_bwd, products="tf32x1",
                                      plain_queued=0), label)
        del q, k, v, do, q3, k3, v3, q4, k4, v4, o4
    return reports


def bf16_units(a, b) -> float:
    """The largest distance of `a` from `b` in bf16 units (2^-8, its unit
    roundoff) of `b`'s largest entry. Where the kernel and the plain version
    round a probability or dS to bf16 apart, an output moves by one unit of
    the largest term it sums, which a causal row or column of few terms can
    hold alone; so the unit is taken of the output's scale, not of each
    entry."""
    scale = float(b.abs().max())
    return float((a.double() - b.double()).abs().max()) / (2.0 ** -8 * (scale if scale > 0 else 1.0))


def bf16_inputs(bh: int, s: int, d: int, seed: int):
    """Seeded f32 q, k, v, dO `[BH, S, D]` on the card and q, k, v rounded to bf16."""
    import torch

    q, k, v, do = flash_inputs(bh, s, d, seed)
    return (q, k, v, do), tuple(t.to(torch.bfloat16) for t in (q, k, v))


def bf16_check(bh: int, s: int, d: int, seed: int, f64: bool = False) -> dict:
    """The bf16 trio against its plain versions at one shape: o, lse (f32)
    and the bf16 cotangents within BF16_UNITS bf16 units of their largest
    entry (`bf16_units`); the cotangents bf16. With `f64`, the public
    op (`flash_attention(q16, k16, v16, causal=True, precision='default')`
    and its autograd) against float64 dense attention of the unrounded f32
    inputs at the JAX package's bounds (tests/test_flash.py:338-367): o
    within rtol 0.06, atol 0.03; each gradient within 0.08 of max(|ref|,
    1). Returns the absolute errors."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc
    from federated_pytorch_test_tpu_torch.ops.attention import dense_attention

    (q, k, v, do), (q16, k16, v16) = bf16_inputs(bh, s, d, seed)
    scale = 1.0 / d ** 0.5
    qs = fc.prescale_q(q16, scale)
    o, lse = fc.flash_fwd_bf16(qs, k16, v16)
    o_ref, lse_ref = fc.flash_fwd_bf16_plain(qs, k16, v16)
    delta = (do * o_ref).sum(-1)
    do16 = do.to(torch.bfloat16)
    dq = fc.flash_bwd_dq_bf16(qs, k16, v16, do16, lse_ref, delta, scale)
    dk, dv = fc.flash_bwd_dkv_bf16(qs, k16, v16, do16, lse_ref, delta)
    dq_ref = fc.flash_bwd_dq_bf16_plain(qs, k16, v16, do16, lse_ref, delta, scale)
    dk_ref, dv_ref = fc.flash_bwd_dkv_bf16_plain(qs, k16, v16, do16, lse_ref, delta)
    torch.cuda.synchronize()
    pairs = {"o": (o, o_ref), "dq": (dq, dq_ref), "dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    units = {n: bf16_units(a, b) for n, (a, b) in pairs.items()}
    units["lse"] = bf16_units(lse, lse_ref)
    abs_errs = {n: float((a.float() - b.float()).abs().max()) for n, (a, b) in pairs.items()}
    abs_errs["lse"] = float((lse - lse_ref).abs().max())
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (o, lse, dq, dk, dv))
    dtypes = all(t.dtype == torch.bfloat16 for t in (dq, dk, dv)) and o.dtype == torch.float32
    f64_line, f64_ok, op_launches = "", True, {}
    if f64:
        leaves = [t.detach().clone().requires_grad_(True) for t in (q16, k16, v16)]
        torch.cuda.synchronize()
        fc.reset_launch_counts()
        out = fc.flash_attention(*(t.view(1, bh, s, d).transpose(1, 2) for t in leaves), causal=True,
                                 precision="default")
        dout = do.view(1, bh, s, d).transpose(1, 2)
        g = torch.autograd.grad(out, leaves, dout.to(out.dtype))
        torch.cuda.synchronize()
        op_launches = {n: c for n, c in fc.LAUNCHES.items() if c}
        ref_leaves = [t.double().view(1, bh, s, d).transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v)]
        ref = dense_attention(*ref_leaves, causal=True)
        g64 = torch.autograd.grad(ref, ref_leaves, dout.double())
        out_err = float(((out.detach().double() - ref.detach()).abs() - 0.06 * ref.detach().abs()).max())
        grad_errs = {f"d{n}": float((a.view(1, bh, s, d).transpose(1, 2).double() - b).abs().max()
                                    / max(float(b.abs().max()), 1.0))
                     for n, a, b in zip("qkv", g, g64)}
        f64_ok = (out_err <= 0.03 and max(grad_errs.values()) < 0.08 and out.dtype == torch.bfloat16
                  and all(t.dtype == torch.bfloat16 for t in g))
        f64_line = (f" op_vs_f64 o_excess={out_err:.3e} (atol 0.03 past rtol 0.06) "
                    + " ".join(f"{n}={e:.3e}" for n, e in grad_errs.items()) + f" dtypes_bf16={f64_ok}")
        del leaves, out, g, ref_leaves, ref, g64
    print(f"flash bf16 BH={bh} S={s} D={d} " + " ".join(f"{n}_units={u:.3f}" for n, u in units.items())
          + f" lse_rel={rel_err(lse, lse_ref):.3e} finite={finite} dtypes={dtypes}" + f64_line, flush=True)
    if not finite or not dtypes or not max(units.values()) <= BF16_UNITS or not f64_ok:
        fail(f"flash bf16 BH={bh} S={s} D={d}: kernel disagrees with its plain version or float64: {units} "
             f"(finite={finite}, dtypes={dtypes}, vs float64 ok={f64_ok})")
    return abs_errs, op_launches


def phase_flash_bf16():
    """The bf16 causal trio (`cast16`) against its plain versions at every head
    dim and at BF16_PATHS (also the public op against float64); two launches
    equal bits there; times beside the bound (bf16 products at 989
    TFLOP/s, the exps or the bytes) and `scaled_dot_product_attention` on the
    same bf16 inputs."""
    import torch
    import torch.nn.functional as F

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    for d in FLASH_DIMS:
        for s in (256, 1024):
            bf16_check(FLASH_SWEEP_BH, s, d, seed=31 + s + d)
    for s in (128, 2048):  # D 128 at the other sequences, the public op against float64 from S 2048
        bf16_check(FLASH_SWEEP_BH, s, 128, seed=31 + s, f64=s == 2048)
    padded_check("bf16", True)
    reports, launches = {}, Counter()
    for bh, s, d in BF16_PATHS:
        abs_errs, op_launches = bf16_check(bh, s, d, seed=37, f64=True)
        # the public op, forward and backward: one launch of each of the trio, nothing else
        counted = {n: op_launches.get(n, 0) for n in fc.BF16_KERNELS}
        counted["other flash kernels"] = sum(c for n, c in op_launches.items() if n not in fc.BF16_KERNELS)
        gate_launches(f"flash bf16 op BH={bh} S={s} D={d}", counted,
                      {**{n: 1 for n in fc.BF16_KERNELS}, "other flash kernels": 0})
        launches.update(op_launches)
        (q, k, v, do), (q16, k16, v16) = bf16_inputs(bh, s, d, seed=41)
        scale = 1.0 / d ** 0.5
        qs = fc.prescale_q(q16, scale)
        o, lse = fc.flash_fwd_bf16_plain(qs, k16, v16)
        delta = (do * o).sum(-1)
        do16 = do.to(torch.bfloat16)
        repeat_check(f"flash_fwd_bf16 BH={bh} S={s} D={d}", lambda: fc.flash_fwd_bf16(qs, k16, v16))
        repeat_check(f"flash_bwd_bf16 BH={bh} S={s} D={d}",
                     lambda: (fc.flash_bwd_dq_bf16(qs, k16, v16, do16, lse, delta, scale),
                              *fc.flash_bwd_dkv_bf16(qs, k16, v16, do16, lse, delta)))
        q4, k4, v4 = (t.detach().view(1, bh, s, d).requires_grad_(True) for t in (q16, k16, v16))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        do4 = do16.view(1, bh, s, d)

        def sdpa_bwd():
            torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

        calls = {
            "flash_fwd_bf16": (lambda: fc.flash_fwd_bf16(qs, k16, v16), lambda: fc.flash_fwd_bf16_plain(qs, k16, v16),
                               lambda: F.scaled_dot_product_attention(q4.detach(), k4.detach(), v4.detach(),
                                                                      is_causal=True)),
            "flash_bwd_dq_bf16": (lambda: fc.flash_bwd_dq_bf16(qs, k16, v16, do16, lse, delta, scale),
                                  lambda: fc.flash_bwd_dq_bf16_plain(qs, k16, v16, do16, lse, delta, scale), sdpa_bwd),
            "flash_bwd_dkv_bf16": (lambda: fc.flash_bwd_dkv_bf16(qs, k16, v16, do16, lse, delta),
                                   lambda: fc.flash_bwd_dkv_bf16_plain(qs, k16, v16, do16, lse, delta), sdpa_bwd),
        }
        pairs = bh * s * (s + 1) // 2
        op16, op32, row = bh * s * d * 2, bh * s * d * 4, bh * s * 4
        work = {  # bf16 operands in, o f32 out (the backward's delta reads it); bf16 cotangents out
            "flash_fwd_bf16": (3 * op16 + op32 + row, 2 * 2 * d * pairs, pairs),
            "flash_bwd_dq_bf16": (4 * op16 + 2 * row + op16, 3 * 2 * d * pairs, pairs),
            "flash_bwd_dkv_bf16": (4 * op16 + 2 * row + 2 * op16, 4 * 2 * d * pairs, pairs),
        }
        abs_of = {"flash_fwd_bf16": max(abs_errs["o"], abs_errs["lse"]), "flash_bwd_dq_bf16": abs_errs["dq"],
                  "flash_bwd_dkv_bf16": max(abs_errs["dk"], abs_errs["dv"])}
        q3, k3, v3 = (t.detach().requires_grad_(True) for t in (q16, k16, v16))

        def flash_fwd_bwd():
            torch.autograd.grad(fc._FlashCausalBf16.apply(q3, k3, v3, scale), (q3, k3, v3), do)

        def sdpa_fwd_bwd():
            torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), (q4, k4, v4), do4)

        label = f"BH={bh} S={s} D={d} causal bf16"
        rows = time_flash(label, calls, work, abs_of, flash_fwd_bwd, sdpa_fwd_bwd, products="bf16", plain_queued=0)
        add_shape(reports, rows, label)  # the LM shape's row leads; the others ride along
        del q, k, v, do, q16, k16, v16, qs, q3, k3, v3, q4, k4, v4, o4
    return reports, dict(launches)


def moe_shapes(cfg):
    """(G, C at the train batch, C at the eval batch, D, H) of the MoE ViT path's grouped GEMMs."""
    from federated_pytorch_test_tpu_torch.models import ViT

    model = ViT(**cfg.model_kwargs)
    moe = model.block0.moe
    g = cfg.n_clients * moe.n_experts
    return g, moe.capacity(cfg.batch * model.tokens), moe.capacity(cfg.eval_batch * model.tokens), model.dim, moe.hidden


def grouped_cases(cfg):
    """(label, role, operand shapes, operand transposed?) of every grouped GEMM
    call on the MoE ViT path: the forward of fc1 and fc2 (training and
    evaluation batches), their input gradients dA = dC·Bᵀ and their weight
    gradients dB = Aᵀ·dC, each operand as the autograd function passes it."""
    g, c, c_eval, d, h = moe_shapes(cfg)
    return (
        ("fwd fc1", "grouped_matmul", ((g, c, d), (g, d, h))),
        ("fwd fc2", "grouped_matmul", ((g, c, h), (g, h, d))),
        ("eval fc1", "grouped_matmul", ((g, c_eval, d), (g, d, h))),
        ("dlhs fc2", "grouped_matmul_dlhs", ((g, c, d), (g, h, d))),
        ("dlhs fc1", "grouped_matmul_dlhs", ((g, c, h), (g, d, h))),
        ("drhs fc1", "grouped_matmul_drhs", ((g, c, d), (g, c, h))),
        ("drhs fc2", "grouped_matmul_drhs", ((g, c, h), (g, c, d))),
    )


def grouped_role(role):
    """(kernel wrapper, plain version, one library call) of a grouped role, each
    taking the role's two operands; the contraction's (lhs, rhs) views."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    views = {
        "grouped_matmul": lambda a, b: (a, b),
        "grouped_matmul_dlhs": lambda dc, w: (dc, w.transpose(1, 2)),
        "grouped_matmul_drhs": lambda x, dc: (x.transpose(1, 2), dc),
    }[role]
    kernel = {"grouped_matmul": gg.grouped_matmul_fwd, "grouped_matmul_dlhs": gg.grouped_matmul_dlhs,
              "grouped_matmul_drhs": gg.grouped_matmul_drhs}[role]
    return kernel, (lambda a, b: gg.grouped_matmul_plain(*views(a, b))), (lambda a, b: torch.bmm(*views(a, b))), views


def phase_grouped():
    """The grouped GEMM at every shape of the MoE ViT path: the kernel against
    its plain version in float64 (relative 1e-5 of the largest reference
    entry), two launches equal bits, the split contraction's sum kernel
    against its plain version; times of the kernel, the plain version and
    `torch.bmm` (TF32 off) beside the bound."""
    import torch

    from federated_pytorch_test_tpu_torch.engine import get_preset
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    cfg = get_preset("fedavg", model="vit", model_kwargs=VIT_MOE_KWARGS)
    assert not torch.backends.cuda.matmul.allow_tf32
    report = {}
    for i, (label, role, shapes) in enumerate(grouped_cases(cfg)):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        a, b = (torch.randn(*sh, device="cuda", generator=gen) for sh in shapes)
        kernel, plain, library, views = grouped_role(role)
        lhs, rhs = views(a, b)
        (g, m, k), n = lhs.shape, rhs.shape[2]
        runs = [kernel(a, b) for _ in range(2)]
        ref64 = plain(a.double(), b.double())
        ref32 = plain(a, b)
        torch.cuda.synchronize()
        same = torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32))
        err, err32 = rel_err(runs[0].double(), ref64), rel_err(ref32.double(), ref64)
        splits, chunk = gg.split_k(g, m, n, k)
        finite = bool(torch.isfinite(runs[0]).all())
        print(f"grouped {label} [{g},{m},{k}]x[{g},{k},{n}] lhs_t={int(lhs.stride(1) == 1)} "
              f"rhs_t={int(rhs.stride(1) == 1)} splits={splits} kernel_vs_f64={err:.3e} plain_f32_vs_f64={err32:.3e} "
              f"bitwise_equal={same} finite={finite}", flush=True)
        if not finite or not same or not err <= RTOL:
            fail(f"grouped {label}: kernel vs float64 {err:.3e} (bitwise equal {same}, finite {finite})")
        r = {"max_abs_err": float((runs[0] - ref32).abs().max()), "shape": f"[{g},{m},{k}]x[{g},{k},{n}]",
             "splits": splits}
        del runs, ref64, ref32
        for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
            r[key], r[key.replace("ms", "device_ms")] = time_ms(lambda: fn(a, b), 20)
        flops = 2 * g * m * k * n
        r.update(flash_bounds((g * m * k + g * k * n + g * m * n) * 4, flops, 0))
        print(f"timing {role} {label} ms={r['ms']:.6f} device_ms={r['device_ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"plain_device_ms={r['plain_device_ms']:.6f} library_ms={r['library_ms']:.6f} "
              f"library_device_ms={r['library_device_ms']:.6f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}: "
              f"{r['bound_term']}) ffma_bound_ms={r['ffma_bound_ms']:.6f} gflop={flops / 1e9:.3f} "
              f"achieved_tflops={flops / r['device_ms'] / 1e9:.3f} share_of_bound={r['bound_ms'] / r['device_ms']:.3f}",
              flush=True)
        report.setdefault(role, r)  # the JSON line reports each role at its first (fc1 or fc2 training) shape
        if role == "grouped_matmul_drhs" and "grouped_matmul_sum" not in report and splits > 1:
            report["grouped_matmul_sum"] = sum_check(g, m, n, splits, seed=200 + i)
        del a, b
    for shape in GROUPED_TAILS:
        grouped_tail_check(*shape)
    return report


def grouped_tail_check(g: int, m: int, k: int, n: int, dtype=None) -> None:
    """Every role of the grouped GEMM at a ragged shape (M, K, N off the
    tiles, rows off 16 bytes: the kernel's narrow copies), its operand views
    as autograd passes them, two launches equal bits: f32 operands within
    RTOL of float64; bf16 operands within GROUPED_BF16_UNITS of the float64
    product rounded to bf16."""
    import torch

    dtype = dtype or torch.float32
    gen = torch.Generator(device="cuda").manual_seed(g + m + k + n)
    a, b, dc = (torch.randn(*sh, device="cuda", generator=gen).to(dtype) for sh in ((g, m, k), (g, k, n), (g, m, n)))
    for role, args in (("grouped_matmul", (a, b)), ("grouped_matmul_dlhs", (dc, b)), ("grouped_matmul_drhs", (a, dc))):
        kernel, plain, _, _ = grouped_role(role)
        runs = [kernel(*args) for _ in range(2)]
        ref64 = plain(*(t.double() for t in args))
        torch.cuda.synchronize()
        same = bitwise_equal(runs[0], runs[1])
        finite = bool(torch.isfinite(runs[0]).all())
        if dtype == torch.bfloat16:
            err = bf16_units(runs[0], ref64.to(dtype))
            ok, what = err <= GROUPED_BF16_UNITS and runs[0].dtype == dtype, "bf16_units_vs_f64"
        else:
            err = rel_err(runs[0].double(), ref64)
            ok, what = err <= RTOL, "kernel_vs_f64"
        tag = "grouped tail" + (" bf16" if dtype == torch.bfloat16 else "")
        print(f"{tag} {role} G={g} M={m} K={k} N={n} {what}={err:.3e} bitwise_equal={same} finite={finite}",
              flush=True)
        if not finite or not same or not ok or runs[0].shape != ref64.shape:
            fail(f"{tag} {role} ({g}, {m}, {k}, {n}): {what} {err:.3e} (bitwise equal {same})")


def sum_check(g: int, m: int, n: int, splits: int, seed: int, dtype=None) -> dict:
    """The split sum kernel against its plain version (the same order: equal
    bits) at a weight gradient's partials `[S, G, M, N]`, its sum written in
    `dtype` (float32, or bfloat16 rounded once); its times with the L2
    flushed (on the path the partials, 31 MB, are still in L2 from the
    launch that wrote them, and a warm reading beats the bytes bound)."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    dtype = dtype or torch.float32
    role = "grouped_matmul_sum" + ("_bf16" if dtype == torch.bfloat16 else "")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    part = torch.randn(splits, g, m, n, device="cuda", generator=gen)
    out = torch.empty((g, m, n), dtype=dtype, device="cuda")
    got, want = gg.grouped_sum(part, out), gg.grouped_sum_plain(part, dtype)
    torch.cuda.synchronize()
    same = bitwise_equal(got, want)
    print(f"{role} [{splits},{g},{m},{n}] bitwise_equal_to_plain={same}", flush=True)
    if not same:
        fail(f"{role} differs from its plain version (the same order of additions)")
    r = {"max_abs_err": float((got.float() - want.float()).abs().max()), "shape": f"[{splits},{g},{m},{n}]",
         "splits": splits, "l2": "flushed before every call"}
    for key, fn in (("ms", lambda p: gg.grouped_sum(p, out)),
                    ("plain_ms", lambda p: gg.grouped_sum_plain(p, dtype)),
                    ("library_ms", lambda p: p.sum(0).to(dtype))):
        r[key], r[key.replace("ms", "device_ms")] = time_cold_ms(lambda: fn(part), 20)
    out_bytes = 2 if dtype == torch.bfloat16 else 4
    r.update(flash_bounds(splits * g * m * n * 4 + g * m * n * out_bytes, (splits - 1) * g * m * n, 0))
    r["ffma_bound_ms"] = r["bound_ms"]
    print(f"timing {role} [{splits},{g},{m},{n}] l2=flushed ms={r['ms']:.6f} "
          f"device_ms={r['device_ms']:.6f} plain_ms={r['plain_ms']:.6f} plain_device_ms={r['plain_device_ms']:.6f} "
          f"library_ms={r['library_ms']:.6f} library_device_ms={r['library_device_ms']:.6f} "
          f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) share_of_bound={r['bound_ms'] / r['device_ms']:.3f}",
          flush=True)
    beaten = [key for key in ("device_ms", "plain_device_ms", "library_device_ms") if r[key] < r["bound_ms"]]
    if beaten:
        fail(f"{role}: {beaten} below the bytes bound {r['bound_ms']:.6f} ms (the L2 flush failed)")
    return r


def phase_grouped_bf16():
    """12″. The bf16 grouped GEMM (`csrc/grouped_gemm_bf16.cu`) at every
    shape of the MoE ViT path on bf16 operands (`grouped_cases`: both
    forwards, the evaluation forward, both input gradients with Bᵀ a view,
    both weight gradients split in 5 and summed): within GROUPED_BF16_UNITS
    bf16 units of the float64 product of the same bf16 operands rounded to
    bf16, two launches equal bits; the bf16 split sum equal in bits to its
    plain version; every role at the ragged shapes; times of the kernel, the
    plain version (f32 `torch.bmm`, rounded) and `torch.bmm` on the bf16
    operands beside the bound (bf16 products at 989 TFLOP/s or the bytes)."""
    import torch

    from federated_pytorch_test_tpu_torch.engine import get_preset
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    cfg = get_preset("fedavg", model="vit", model_kwargs=VIT_MOE_KWARGS)
    report = {}
    for i, (label, role, shapes) in enumerate(grouped_cases(cfg)):
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        a, b = (torch.randn(*sh, device="cuda", generator=gen).to(torch.bfloat16) for sh in shapes)
        kernel, plain, library, views = grouped_role(role)
        lhs, rhs = views(a, b)
        (g, m, k), n = lhs.shape, rhs.shape[2]
        runs = [kernel(a, b) for _ in range(2)]
        ref = plain(a.double(), b.double()).to(torch.bfloat16)
        out_plain = plain(a, b)
        torch.cuda.synchronize()
        same = bitwise_equal(runs[0], runs[1])
        units, plain_units = bf16_units(runs[0], ref), bf16_units(out_plain, ref)
        splits, _ = gg.split_k(g, m, n, k, torch.bfloat16)
        finite = bool(torch.isfinite(runs[0]).all())
        print(f"grouped bf16 {label} [{g},{m},{k}]x[{g},{k},{n}] lhs_t={int(lhs.stride(1) == 1)} "
              f"rhs_t={int(rhs.stride(1) == 1)} splits={splits} dtype={str(runs[0].dtype)[6:]} "
              f"bf16_units_vs_f64={units:.3f} plain_bf16_units_vs_f64={plain_units:.3f} bitwise_equal={same} "
              f"finite={finite}", flush=True)
        if not finite or not same or not units <= GROUPED_BF16_UNITS or runs[0].dtype != torch.bfloat16:
            fail(f"grouped bf16 {label}: {units:.3f} bf16 units from float64 (bitwise equal {same}, finite {finite})")
        r = {"max_abs_err": float((runs[0].float() - out_plain.float()).abs().max()),
             "shape": f"[{g},{m},{k}]x[{g},{k},{n}]", "splits": splits}
        del runs, ref, out_plain
        for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
            r[key], r[key.replace("ms", "device_ms")] = time_ms(lambda: fn(a, b), 20)
        flops = 2 * g * m * k * n
        r.update(flash_bounds((g * m * k + g * k * n + g * m * n) * 2, flops, 0, products="bf16"))
        print(f"timing {role}_bf16 {label} ms={r['ms']:.6f} device_ms={r['device_ms']:.6f} "
              f"plain_ms={r['plain_ms']:.6f} plain_device_ms={r['plain_device_ms']:.6f} "
              f"library_ms={r['library_ms']:.6f} library_device_ms={r['library_device_ms']:.6f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}: {r['bound_term']}) gflop={flops / 1e9:.3f} "
              f"achieved_tflops={flops / r['device_ms'] / 1e9:.3f} share_of_bound={r['bound_ms'] / r['device_ms']:.3f}",
              flush=True)
        report.setdefault(f"{role}_bf16", r)  # each role at its first (fc1 or fc2 training) shape
        if role == "grouped_matmul_drhs" and "grouped_matmul_sum_bf16" not in report and splits > 1:
            report["grouped_matmul_sum_bf16"] = sum_check(g, m, n, splits, seed=400 + i, dtype=torch.bfloat16)
        del a, b
    for shape in GROUPED_TAILS:
        grouped_tail_check(*shape, dtype=torch.bfloat16)
    return report


def attention_grad_layers(model, gid: int) -> int:
    """Attention layers whose backward runs in a gradient pass of group `gid`:
    every block from the group's first block on, all of them for a group
    before the first block (the embedding) and none for a group after the
    last (the head). Groups name their blocks `block<i>`
    (models/transformer.py); blocks before the group's are frozen, so no
    gradient flows back through them."""
    names = [path[0] for path in model.GROUP_PATHS[gid]]
    blocks = [int(n[len("block"):]) for n in names if n.startswith("block")]
    if blocks:
        return model.DEPTH - min(blocks)
    return model.DEPTH if any(n in ("embed", "pos_embed") for n in names) else 0


def active_blocks(model, gid: int) -> int:
    """Blocks whose own weights group `gid` trains (`block<i>` in its paths)."""
    return sum(path[0].startswith("block") for path in model.GROUP_PATHS[gid])


def expected_launches(rec, model=None, sweep_passes: int = 0, remat: bool = False) -> dict:
    """The launches a training run's own records imply. Each round records
    the optimizer's batched passes (`objective_passes`: with a gradient,
    without one, and directions, one per inner iteration). The direction
    kernels launch once per direction. In a transformer, a layer's backward
    (`backward`) runs once per gradient pass in each block behind the active
    group, and its forward (`forward`) once per pass of any kind in every
    block: the optimizer's passes and `sweep_passes` per evaluation recorded
    in `test_accuracy` — and under `remat` once more per gradient pass, the
    backward's recomputation (which reruns the evaluation up to the loss);
    a weight gradient (`weight_backward`) once per gradient pass in each
    block the group trains.

    A probe fan (`linesearch_probes > 1`) is one value pass whatever its
    width P: the compact kernels do not run in it, and a transformer runs
    each block once in it — the blocks below the active group for K
    clients, the others for K·P — so each attention layer's forward
    launches once a fan, with no new term."""
    sweeps = Counter((r["nloop"], r["group"]) for r in rec.series.get("test_accuracy", []))
    out = Counter()
    for r in rec.series["objective_passes"]:
        passes = r["value"]
        out["direction"] += passes["direction"]
        if model is not None:
            out["backward"] += attention_grad_layers(model, r["group"]) * passes["grad"]
            out["weight_backward"] += active_blocks(model, r["group"]) * passes["grad"]
            out["forward"] += model.DEPTH * ((2 if remat else 1) * passes["grad"] + passes["value"]
                                             + sweep_passes * sweeps[(r["nloop"], r["group"])])
    return dict(out)


def expected_grouped(exp: dict, cfg) -> dict:
    """The grouped GEMM's launches on the MoE ViT path from `expected_launches`:
    two a block (fc1, fc2) in every forward, two input gradients in every
    block the gradient crosses, two weight gradients in the trained block,
    and one split sum per weight gradient where `split_k` splits it; under
    the roles of the config's compute dtype (`_bf16` at bfloat16), and 0
    under the other dtype's."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    g, c, _, d, h = moe_shapes(cfg)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    split = sum(gg.split_k(g, m, n, c, dtype)[0] > 1 for m, n in ((d, h), (h, d)))  # dW1 [D, H], dW2 [H, D]
    counts = (2 * exp["forward"], 2 * exp["backward"], 2 * exp["weight_backward"], split * exp["weight_backward"])
    roles = gg.BF16_ROLES if cfg.compute_dtype == "bfloat16" else gg.ROLES
    return {**dict.fromkeys((*gg.ROLES, *gg.BF16_ROLES), 0), **dict(zip(roles, counts))}


def gate_launches(path: str, launches: dict, expected: dict) -> None:
    """Each kernel's launches against the count the run implies, printed side
    by side; any difference fails."""
    for name, want in expected.items():
        print(f"{path} launches {name} expected={want} counted={launches[name]}", flush=True)
    wrong = {name: (want, launches[name]) for name, want in expected.items() if launches[name] != want}
    if wrong:
        fail(f"{path}: launches differ from the count the run implies (expected, counted): {wrong}")


def phase_parity():
    """The tiny verify drive on the card with both direction backends."""
    import numpy as np

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset

    recs = {}
    for direction in ("compact", "pallas"):
        cfg = get_preset("fedavg", batch=40, nloop=1, nadmm=1, max_groups=1, lbfgs_direction=direction)
        recs[direction] = Trainer(cfg, verbose=False, source=synthetic_cifar(240, 60)).run()
    def values(rec, name):
        return [float(v) for r in rec.series[name] for v in np.atleast_1d(r["value"])]

    for name in ("train_loss", "dual_residual"):
        a, b = values(recs["pallas"], name), values(recs["compact"], name)
        worst = max(abs(x - z) / max(abs(z), 1e-30) for x, z in zip(a, b))
        print(f"parity {name} pallas-vs-compact max_rel={worst:.3e}", flush=True)
        if len(a) != len(b) or not worst <= 1e-3:
            fail(f"parity: {name} differs between direction backends ({worst:.3e})")


def phase_train(metrics_out, profile: bool):
    """The main path, through the entry points a user calls."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc

    cfg = get_preset("fedavg", nloop=1, lbfgs_direction="pallas")
    t0 = time.perf_counter()
    source = synthetic_cifar(50_000, 10_000, seed=0)
    tr = Trainer(cfg, verbose=False, source=source)
    print(f"train setup: {cfg.model} K={cfg.n_clients} batch={cfg.batch} nadmm={cfg.nadmm} "
          f"groups={tr.group_order} params={tr.n_params} steps/epoch={tr.fed.steps_per_epoch(cfg.batch)} "
          f"setup_s={time.perf_counter() - t0:.3f}", flush=True)

    cc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cc.LAUNCHES)

    times = {}
    for r in rec.series["step_time"]:
        if "nadmm" in r:
            key = (r["group"], r["nadmm"])
            times[key] = times.get(key, 0.0) + r["value"]["seconds"]
    losses = {}
    for r in rec.series["train_loss"]:
        losses.setdefault((r["group"], r["nadmm"]), []).append(r["value"])
    duals = {(r["group"], r["nadmm"]): r["value"] for r in rec.series["dual_residual"]}
    accs = {(r["group"], r["nadmm"]): r["value"] for r in rec.series["test_accuracy"]}
    for key in duals:
        last = np.asarray(losses[key][-1])
        print(f"round group={key[0]} nadmm={key[1]} train_loss_last={','.join(f'{v:.6e}' for v in last)} "
              f"dual={duals[key]:.6e} acc={','.join(f'{a:.4f}' for a in accs[key])} wall_s={times[key]:.3f}",
              flush=True)
    n_steps = len(rec.series["train_loss"])
    print(f"train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"launches={json.dumps(launches)}", flush=True)
    if metrics_out:
        rec.save(metrics_out)

    all_losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    if not np.all(np.isfinite(all_losses)) or rec.first_nonfinite is not None:
        fail(f"non-finite training loss: {rec.first_nonfinite}")
    final_acc = np.asarray(rec.series["test_accuracy"][-1]["value"])
    chance = 1.0 / tr.fed.num_classes
    if not np.all(final_acc > chance):
        fail(f"final accuracy {final_acc} not above chance {chance}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    n_dir = expected_launches(rec)["direction"]
    gate_launches("train", launches, {name: n_dir for name in cc.LAUNCHES})
    if profile:
        profile_epoch(tr)
    return launches, wall, rec


def profile_epoch(tr, gid=None, max_steps=None):
    """Kernel time by name and the device's busy share over one epoch of
    group `gid` (the first of the order by default), or over its first
    `max_steps` minibatches."""
    import torch

    from federated_pytorch_test_tpu_torch.engine.steps import round_init, run_epoch

    ctx = tr.ctx(tr.group_order[0] if gid is None else gid)
    idx = tr.epoch_indices(99, ctx.gid, 0, 0)[:max_steps]

    def epoch():
        lstate, cstate = round_init(ctx, tr.flat)
        run_epoch(ctx, tr.flat.clone(), lstate, dict(tr.stats), tr.shard_imgs, tr.shard_labels, idx, tr.mean, tr.std,
                  cstate if ctx.strategy == "admm" else None)
        torch.cuda.synchronize()

    profile_fn(f"group={ctx.gid}", epoch)


def profile_fn(label: str, epoch) -> None:
    """Kernel time by name and the device's busy share over one call of `epoch`."""
    import torch
    import warnings

    from torch.profiler import ProfilerActivity, profile as tprofile

    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")

    t0 = time.perf_counter()
    epoch()  # the same epoch without the profiler: the wall the busy time is read against
    wall_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch()
    prof_wall_us = (time.perf_counter() - t0) * 1e6
    def self_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device kernels only: an operator's event repeats its kernels' time
    events = [
        e for e in prof.key_averages()
        if self_us(e) > 0 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(self_us(e) for e in events)
    print(f"profile {label} epoch wall_ms={wall_us / 1e3:.3f} profiled_wall_ms={prof_wall_us / 1e3:.3f} "
          f"device_busy_ms={busy_us / 1e3:.3f} idle_share={max(0.0, 1 - busy_us / wall_us):.4f}", flush=True)
    for e in sorted(events, key=lambda e: -self_us(e))[:12]:
        print(f"profile kernel={e.key[:70]!r} calls={e.count} self_device_ms={self_us(e) / 1e3:.3f}",
              flush=True)


def phase_lm_parity():
    """The LM's first round (K=4, S=256, group 0) step by step: before each
    L-BFGS step the 'dense' (plain) and the 'flash' (kernel) model get the
    same parameters and optimizer state, taken from the dense trajectory."""
    import torch

    from federated_pytorch_test_tpu_torch.consensus import FedAvgState, fedavg_round
    from federated_pytorch_test_tpu_torch.engine.steps import _group_params
    from federated_pytorch_test_tpu_torch.federated_lm import FederatedLM, LMConfig, lm_loss, lm_train_step
    from federated_pytorch_test_tpu_torch.optim import clone_state, lbfgs_init

    def grad(ctx, flat, toks):
        x = ctx.partition.extract(flat, ctx.gid).contiguous().requires_grad_(True)
        with torch.enable_grad():
            loss = lm_loss(ctx.model, _group_params(ctx, flat, x), toks).sum()
        return torch.autograd.grad(loss, x)[0]

    lms = {impl: FederatedLM(LMConfig(seq=256, max_groups=1, attn_impl=impl), verbose=False)
           for impl in ("dense", "flash")}
    dense = lms["dense"]
    gid = dense.group_order[0]
    ctxs = {impl: lm.ctx(gid) for impl, lm in lms.items()}
    flat = dense.flat.clone()
    state = lbfgs_init(dense.partition.extract(flat, gid).contiguous(), ctxs["dense"].lbfgs)
    worst = {"train_loss": 0.0, "params": 0.0, "dual_residual": 0.0}
    for s in range(dense.train.shape[1]):
        toks = dense.train[:, s]
        gd, gf = (grad(ctx, flat, toks) for ctx in ctxs.values())  # at the step's entry
        out = {impl: lm_train_step(ctx, flat.clone(), clone_state(state), toks) for impl, ctx in ctxs.items()}
        (fd, sd, ld), (ff, sf, lf) = out["dense"], out["flash"]
        xd, xf = dense.partition.extract(fd, gid), dense.partition.extract(ff, gid)
        step = {"train_loss": float(((lf - ld).abs() / ld.abs()).max()),
                "params": float((xf - xd).abs().max() / xd.abs().max())}
        print(f"lm parity step {s} grad_rel={rel_err(gf, gd):.3e} "
              + " ".join(f"{k}_rel={v:.3e}" for k, v in step.items())
              + f" evals dense={sd.func_evals.tolist()} flash={sf.func_evals.tolist()}"
              + f" probes dense={sd.ls_evals.tolist()} flash={sf.ls_evals.tolist()}", flush=True)
        worst = {k: max(v, step.get(k, 0.0)) for k, v in worst.items()}
        if s == dense.train.shape[1] - 1:  # the averaging round of each last step
            duals = [float(fedavg_round(x, FedAvgState(z=torch.zeros_like(x[0])))[1]["dual_residual"])
                     for x in (xd, xf)]
            worst["dual_residual"] = abs(duals[1] - duals[0]) / duals[0]
        flat, state = fd, sd
    print("lm parity flash-vs-dense per step " + " ".join(f"{k}_max_rel={v:.3e}" for k, v in worst.items()),
          flush=True)
    if not max(worst.values()) <= 1e-3:
        fail(f"lm parity: a step differs between dense and flash attention: {worst}")


def phase_lm_train(metrics_out, profile: bool):
    """The LM path at full width, through the entry point a user calls."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.federated_lm import FederatedLM, LMConfig
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    cfg = LMConfig()
    t0 = time.perf_counter()
    lm = FederatedLM(cfg, verbose=True)
    print(f"lm setup: K={cfg.k} vocab={cfg.vocab} dim={cfg.dim} heads={cfg.num_heads} seq={cfg.seq} "
          f"batch={cfg.batch} minibatches/epoch={cfg.n_batch} attn={cfg.attn_impl} params={lm.partition.total} "
          f"groups={lm.group_order} setup_s={time.perf_counter() - t0:.3f}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = lm.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)

    for r in rec.series["step_time"]:
        if r["value"]["phase"] == "round":
            print(f"lm round group={r['group']} wall_s={r['value']['seconds']:.3f}", flush=True)
    n_steps = len(rec.series["train_loss"])
    print(f"lm train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={json.dumps(launches)}", flush=True)
    if metrics_out:
        rec.save(metrics_out)

    all_losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    if not np.all(np.isfinite(all_losses)) or rec.first_nonfinite is not None:
        fail(f"lm: non-finite training loss: {rec.first_nonfinite}")
    final_acc = np.asarray(rec.series["test_accuracy"][-1]["value"])
    floor = 5.0 / cfg.vocab
    print(f"lm final next-token accuracy {final_acc.round(4).tolist()} (floor {floor:.4f})", flush=True)
    if not np.all(final_acc > floor):
        fail(f"lm final accuracy {final_acc} not above {floor}")
    for name in fc.CAUSAL_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the LM path")
    exp = expected_launches(rec, lm.model, sweep_passes=1)  # an evaluation is one pass over the test sequences
    gate_launches("lm", launches, {"flash_fwd": exp["forward"], "flash_bwd_dq": exp["backward"],
                                   "flash_bwd_dkv": exp["backward"]})
    if profile:
        profile_lm_epoch(lm)
    return launches, wall


def profile_lm_epoch(lm):
    """Kernel time by name and the device's busy share over one group-0 LM epoch."""
    import torch

    from federated_pytorch_test_tpu_torch.federated_lm import run_epoch
    from federated_pytorch_test_tpu_torch.optim import lbfgs_init

    ctx = lm.ctx(lm.group_order[0])

    def epoch():
        flat = lm.flat.clone()
        run_epoch(ctx, flat, lbfgs_init(lm.partition.extract(flat, ctx.gid).contiguous(), ctx.lbfgs), lm.train)
        torch.cuda.synchronize()

    profile_fn(f"lm group={ctx.gid}", epoch)


def phase_vit_parity():
    """The ViT's first round (group 0, batch 64) step by step: before each
    L-BFGS step the 'dense' (plain) and the 'flash' (kernel) model get the
    same parameters and optimizer state, taken from the dense trajectory."""
    import torch

    from federated_pytorch_test_tpu_torch.consensus import FedAvgState, fedavg_round
    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.engine.steps import client_train_step, epoch_batches, round_init
    from federated_pytorch_test_tpu_torch.optim import clone_state

    source = synthetic_cifar(3 * 256, 100, seed=1)
    trs = {impl: Trainer(get_preset("fedavg", model="vit", model_kwargs={**VIT_KWARGS, "attn_impl": impl}, batch=64,
                                    nloop=1, nadmm=1, max_groups=1, lbfgs_direction="pallas"),
                         verbose=False, source=source)
           for impl in ("dense", "flash")}
    dense = trs["dense"]
    gid = dense.group_order[0]
    ctxs = {impl: tr.ctx(gid) for impl, tr in trs.items()}
    flat = dense.flat.clone()
    state, _ = round_init(ctxs["dense"], flat)
    idx = dense.epoch_indices(0, gid, 0, 0)
    worst = {"train_loss": 0.0, "params": 0.0, "dual_residual": 0.0}
    for s, (imgs, labels) in enumerate(epoch_batches(dense.shard_imgs, dense.shard_labels, idx)):
        out = {impl: client_train_step(ctx, flat.clone(), clone_state(state), {}, imgs, labels, dense.mean,
                                       dense.std)
               for impl, ctx in ctxs.items()}
        (fd, sd, _, ld), (ff, _, _, lf) = out["dense"], out["flash"]
        xd, xf = dense.partition.extract(fd, gid), dense.partition.extract(ff, gid)
        worst["train_loss"] = max(worst["train_loss"], float(((lf - ld).abs() / ld.abs()).max()))
        worst["params"] = max(worst["params"], float((xf - xd).abs().max() / xd.abs().max()))
        if s == idx.shape[0] - 1:  # the averaging round after each last step
            duals = [float(fedavg_round(x, FedAvgState(z=torch.zeros_like(x[0])))[1]["dual_residual"])
                     for x in (xd, xf)]
            worst["dual_residual"] = abs(duals[1] - duals[0]) / duals[0]
        flat, state = fd, sd
    print(f"vit parity flash-vs-dense per step ({idx.shape[0]} steps) "
          + " ".join(f"{k}_max_rel={v:.3e}" for k, v in worst.items()), flush=True)
    if not max(worst.values()) <= 1e-3:
        fail(f"vit parity: a step differs between dense and flash attention: {worst}")


def phase_vit_train(metrics_out, profile: bool):
    """The ViT path at full width, through the entry points a user calls."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    cfg = get_preset("fedavg", model="vit", model_kwargs=VIT_KWARGS, nloop=1, nadmm=1, lbfgs_direction="pallas")
    t0 = time.perf_counter()
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(VIT_TRAIN, VIT_TEST, seed=0))
    print(f"vit setup: K={cfg.n_clients} batch={cfg.batch} nadmm={cfg.nadmm} {cfg.model_kwargs} "
          f"tokens={tr.model.tokens} params={tr.n_params} groups={tr.group_order} "
          f"steps/epoch={tr.fed.steps_per_epoch(cfg.batch)} setup_s={time.perf_counter() - t0:.3f}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    cc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**dict(fc.LAUNCHES), **dict(cc.LAUNCHES)}

    for r in rec.series["step_time"]:
        if r["value"]["phase"] == "round":
            print(f"vit round group={r['group']} wall_s={r['value']['seconds']:.3f}", flush=True)
    n_steps = len(rec.series["train_loss"])
    print(f"vit train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={json.dumps(launches)}", flush=True)
    if metrics_out:
        rec.save(metrics_out)

    all_losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    if not np.all(np.isfinite(all_losses)) or rec.first_nonfinite is not None:
        fail(f"vit: non-finite training loss: {rec.first_nonfinite}")
    accs = [(r["group"], np.asarray(r["value"])) for r in rec.series["test_accuracy"]]
    print("vit accuracy per group " + " ".join(f"{g}:{','.join(f'{a:.4f}' for a in v)}" for g, v in accs), flush=True)
    chance = 1.0 / tr.fed.num_classes
    if not np.all(accs[-1][1] > chance):
        fail(f"vit final accuracy {accs[-1][1]} not above chance {chance}")
    for name in fc.RECT_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the ViT path")
    exp = expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs))  # an evaluation: one pass a test batch
    gate_launches("vit", launches, {"flash_fwd_rect": exp["forward"], "flash_bwd_dq_rect": exp["backward"],
                                    "flash_bwd_dkv_rect": exp["backward"],
                                    **{name: exp["direction"] for name in cc.LAUNCHES}})
    if profile:
        profile_epoch(tr)
    return launches, wall


VIT_BF16_KWARGS = {**VIT_KWARGS, "attn_precision": "default"}
VIT_MOE_BF16_KWARGS = {**VIT_MOE_KWARGS, "attn_precision": "default"}
REMAT_RTOL = 1e-5  # remat on against off: the JAX package's bound (tests/test_engine.py:254-264)
LM_BF16_TOL = 3e-2  # the bf16 LM's loss from the f32 one: the JAX package's bf16-vs-f32 bound
LM_GRAD_COSINE = 0.99  # and its gradient's direction


def vit_bf16_run(remat: bool, source):
    """One loop of the ViT fedavg path at compute_dtype bf16, attention at
    'default'; the launches gated exactly. (rec, trainer, launches, wall, peak GB)."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    cfg = get_preset("fedavg", model="vit", model_kwargs=VIT_BF16_KWARGS, nloop=1, nadmm=1, lbfgs_direction="pallas",
                     compute_dtype="bfloat16", remat=remat)
    tr = Trainer(cfg, verbose=False, source=source)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    cc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {**dict(fc.LAUNCHES), **dict(cc.LAUNCHES)}
    n_steps = len(rec.series["train_loss"])
    label = f"vit bf16 remat={remat}"
    print(f"{label} train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={peak:.3f} launches={json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    all_losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    if not np.all(np.isfinite(all_losses)) or rec.first_nonfinite is not None:
        fail(f"{label}: non-finite training loss: {rec.first_nonfinite}")
    accs = [(r["group"], np.asarray(r["value"])) for r in rec.series["test_accuracy"]]
    print(f"{label} accuracy per group " + " ".join(f"{g}:{','.join(f'{a:.4f}' for a in v)}" for g, v in accs),
          flush=True)
    if not np.all(accs[-1][1] > 1.0 / tr.fed.num_classes):
        fail(f"{label}: final accuracy {accs[-1][1]} not above chance")
    exp = expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs), remat=remat)
    gate_launches(label, launches, {
        "flash_fwd_rect_1pass": exp["forward"], "flash_bwd_dq_rect_1pass": exp["backward"],
        "flash_bwd_dkv_rect_1pass": exp["backward"], **{name: 0 for name in fc.RECT_KERNELS},
        **{name: exp["direction"] for name in cc.LAUNCHES}})
    return rec, tr, launches, wall, peak


def phase_vit_bf16_train(metrics_out):
    """The ViT path at compute_dtype bf16 and attention at 'default' (the
    one-pass rectangular kernels), then the same with `remat`: launches
    gated exactly in both; the two trajectories equal within REMAT_RTOL;
    walls and peak memory printed for both."""
    import numpy as np

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar

    source = synthetic_cifar(VIT_TRAIN, VIT_TEST, seed=0)
    rec, tr, launches, wall, peak = vit_bf16_run(False, source)
    if metrics_out:
        rec.save(metrics_out)
    flat = tr.flat.detach().cpu().numpy()
    losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    del tr
    rec_r, tr_r, _, wall_r, peak_r = vit_bf16_run(True, source)
    flat_r = tr_r.flat.detach().cpu().numpy()
    losses_r = np.asarray([r["value"] for r in rec_r.series["train_loss"]])
    errs = {"params": float(np.abs(flat_r - flat).max() / np.abs(flat).max()),
            "train_loss": float(np.abs(losses_r - losses).max() / np.abs(losses).max())}
    print(f"vit bf16 remat-vs-plain " + " ".join(f"{k}_rel={v:.3e}" for k, v in errs.items())
          + f" bitwise={bool(np.array_equal(flat, flat_r))} peak_mem_gb={peak:.3f} remat_peak_mem_gb={peak_r:.3f} "
          f"wall_s={wall:.3f} remat_wall_s={wall_r:.3f}", flush=True)
    if losses.shape != losses_r.shape or not max(errs.values()) <= REMAT_RTOL:
        fail(f"vit bf16: remat changes the trajectory: {errs}")
    return launches, wall, {"peak_gb": peak, "remat_peak_gb": peak_r, "remat_wall_s": wall_r}


def phase_net_bf16_train(metrics_out):
    """The fedavg preset (Net) at compute_dtype bf16 with the fused-kernel
    direction on the full-size synthetic stand-in, one loop: finite losses,
    accuracy above chance, compact launches exact (the compact kernels stay
    f32)."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc

    cfg = get_preset("fedavg", nloop=1, lbfgs_direction="pallas", compute_dtype="bfloat16")
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(50_000, 10_000, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cc.LAUNCHES)
    n_steps = len(rec.series["train_loss"])
    print(f"net bf16 train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={json.dumps(launches)}", flush=True)
    if metrics_out:
        rec.save(metrics_out)
    all_losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    if not np.all(np.isfinite(all_losses)) or rec.first_nonfinite is not None:
        fail(f"net bf16: non-finite training loss: {rec.first_nonfinite}")
    final_acc = np.asarray(rec.series["test_accuracy"][-1]["value"])
    print(f"net bf16 final accuracy {final_acc.round(4).tolist()}", flush=True)
    if not np.all(final_acc > 1.0 / tr.fed.num_classes):
        fail(f"net bf16: final accuracy {final_acc} not above chance")
    gate_launches("net bf16", launches, {name: expected_launches(rec)["direction"] for name in cc.LAUNCHES})
    return launches, wall


def phase_lm_default():
    """TransformerLM at full width (dim 64, 4 heads, S 2048, K=4 clients of 8
    sequences) at attn_precision 'default' and dtype bf16, forward and
    backward through the model (the embedding group's gradient crosses every
    block): the one-pass causal kernels launch exactly once a block each;
    the loss within LM_BF16_TOL of the f32 'highest' model's on the same
    parameters and tokens, the gradient's cosine with it at least
    LM_GRAD_COSINE; walls and peak memory of both."""
    return lm_model_check("lm model", {})


def lm_model_check(path: str, dims: dict):
    """`phase_lm_default`'s check for a TransformerLM of `dims` (its
    constructor's widths; the class defaults where empty), printed under
    `path`: (launches, bf16 wall, extras)."""
    import torch

    from federated_pytorch_test_tpu_torch.engine.steps import GroupContext, _group_params
    from federated_pytorch_test_tpu_torch.models import TransformerLM, init_client_params
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc
    from federated_pytorch_test_tpu_torch.optim import LBFGSConfig

    k, b, s, vocab = 4, 8, 2048, 256
    gen = torch.Generator(device="cuda").manual_seed(43)
    tokens = torch.randint(0, vocab, (k, b, s), device="cuda", generator=gen)
    labels = torch.randint(0, vocab, (k, b, s), device="cuda", generator=gen)
    out = {}
    for label, kw in (("bf16 default", {"attn_precision": "default", "dtype": torch.bfloat16}),
                      ("f32 highest", {})):
        model = TransformerLM(attn_impl="flash", **dims, **kw)
        part = model.partition()
        flat = init_client_params(model, k, seed=0)
        ctx = GroupContext(model=model, shapes=model.shapes(), partition=part, gid=0,
                           lbfgs=LBFGSConfig(line_search=True, batch_mode=True), reg_on_active=False)

        def loss_grad():
            x = part.extract(flat, 0).contiguous().requires_grad_(True)
            dt = model.dtype
            params = _group_params(ctx, flat.to(dt), x.to(dt))
            logits = model.forward_batched(params, tokens)
            loss = torch.nn.functional.cross_entropy(logits.float().reshape(-1, vocab), labels.reshape(-1))
            return loss.detach(), torch.autograd.grad(loss, x)[0]

        loss_grad()  # warm-up: kernels loaded, allocator primed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grad = loss_grad()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fc.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"{path} {label} fwd+bwd wall_ms={1e3 * wall:.3f} peak_mem_gb={peak:.3f} loss={float(loss):.6f} "
              f"launches={json.dumps({n: c for n, c in launches.items() if c})}", flush=True)
        out[label] = (loss, grad, launches, wall, peak)
    (loss, grad, launches, wall, peak), (loss32, grad32, _, wall32, peak32) = out["bf16 default"], out["f32 highest"]
    rel = abs(float(loss) - float(loss32)) / abs(float(loss32))
    cos = float((grad.double() * grad32.double()).sum() / (grad.double().norm() * grad32.double().norm()))
    finite = bool(torch.isfinite(grad).all())
    print(f"{path} bf16-default-vs-f32-highest loss_rel={rel:.3e} grad_cosine={cos:.6f} "
          f"grad_rel={rel_err(grad, grad32):.3e} finite={finite}", flush=True)
    depth = TransformerLM.DEPTH
    gate_launches(path, launches, {fc.ONE_PASS["flash_fwd"]: depth, fc.ONE_PASS["flash_bwd_dq"]: depth,
                                   fc.ONE_PASS["flash_bwd_dkv"]: depth, "flash_fwd": 0})
    if not finite or not rel <= LM_BF16_TOL or not cos >= LM_GRAD_COSINE:
        fail(f"{path} at bf16/'default' strays from f32/'highest': loss {rel:.3e}, gradient cosine {cos:.6f}")
    return launches, wall, {"peak_gb": peak, "f32_wall_s": wall32, "f32_peak_gb": peak32}


def phase_lm_d128(metrics_out, profile: bool):
    """The LM at head dim 128, full width (`LM128_DIMS`: dim 512, 4 heads of
    128, the rest LMConfig's defaults): one round of block0's group (its
    gradient crosses every block) through `federated_lm` at 'highest', the
    causal split kernels at LM128_PATH, launches gated exactly against the
    records, finite losses, every client's next-token accuracy above
    5/vocab; then the model's forward and backward at bf16/'default' (the
    one-pass causal kernels at D 128; the models take f32 q, k, v into the
    attention core) against f32/'highest' (`lm_model_check`). With
    `profile`, block0's epoch profiled. Returns (launches of the round, its
    wall, its peak GB, the model check's)."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.federated_lm import FederatedLM, LMConfig
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    cfg = LMConfig(**LM128_DIMS)
    lm = FederatedLM(cfg, verbose=False)
    lm.group_order = [1]  # block0
    print(f"lm d128 setup: K={cfg.k} vocab={cfg.vocab} dim={cfg.dim} heads={cfg.num_heads} "
          f"head_dim={cfg.dim // cfg.num_heads} seq={cfg.seq} batch={cfg.batch} params={lm.partition.total} "
          f"groups={lm.group_order}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = lm.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(fc.LAUNCHES)
    n_steps = len(rec.series["train_loss"])
    print(f"lm d128 train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={peak:.3f} launches={json.dumps({n: c for n, c in launches.items() if c})}", flush=True)
    if metrics_out:
        rec.save(metrics_out)
    check_finite_run("lm d128", rec)
    final_acc = np.asarray(rec.series["test_accuracy"][-1]["value"])
    floor = 5.0 / cfg.vocab
    print(f"lm d128 final next-token accuracy {final_acc.round(4).tolist()} (floor {floor:.4f})", flush=True)
    if not np.all(final_acc > floor):
        fail(f"lm d128: final accuracy {final_acc} not above {floor}")
    exp = expected_launches(rec, lm.model, sweep_passes=1)
    gate_launches("lm d128", launches, {"flash_fwd": exp["forward"], "flash_bwd_dq": exp["backward"],
                                        "flash_bwd_dkv": exp["backward"],
                                        **{n: 0 for n in launches if n not in fc.CAUSAL_KERNELS}})
    if profile:
        profile_lm_epoch(lm)
    model_launches, model_wall, model_extra = lm_model_check("lm d128 model", LM128_DIMS)
    return launches, wall, {"peak_gb": peak, "model_launches": model_launches, "model_bf16_wall_s": model_wall,
                            **{f"model_{k}": v for k, v in model_extra.items()}}


def phase_vit_d128(metrics_out, profile: bool):
    """The ViT at head dim 128 (`VIT128_KWARGS`: dim 256, 2 heads of 128,
    patch 2): the fedavg preset with the fused-kernel direction, one round
    of block1 (group 2), at f32 (the rectangular split kernels at
    VIT128_PATH) and at compute_dtype bf16 with attention at 'default' (the
    one-pass rectangular kernels); each with flash and compact launches
    gated exactly against the records, finite losses and every client's
    accuracy above chance. With `profile`, each run's block1 epoch
    profiled. Returns ({label: launches}, {label: wall}, {label: peak GB})."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    source = synthetic_cifar(VIT_TRAIN, VIT_TEST, seed=0)
    launches, walls, peaks = {}, {}, {}
    for label, extra, names in (
            ("vit d128 f32", {}, fc.RECT_KERNELS),
            ("vit d128 bf16", {"compute_dtype": "bfloat16"}, tuple(fc.ONE_PASS[n] for n in fc.RECT_KERNELS))):
        kwargs = {**VIT128_KWARGS, **({"attn_precision": "default"} if extra else {})}
        cfg = get_preset("fedavg", model="vit", model_kwargs=kwargs, nloop=1, nadmm=1, lbfgs_direction="pallas",
                         **extra)
        tr = Trainer(cfg, verbose=False, source=source)
        tr.group_order = [2]  # block1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launch_counts()
        cc.reset_launch_counts()
        t0 = time.perf_counter()
        rec = tr.run()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        peaks[label] = torch.cuda.max_memory_allocated() / 1e9
        launch = launches[label] = {**dict(fc.LAUNCHES), **dict(cc.LAUNCHES)}
        n_steps = len(rec.series["train_loss"])
        print(f"{label} setup: K={cfg.n_clients} batch={cfg.batch} {kwargs} tokens={tr.model.tokens} "
              f"params={tr.n_params} groups={tr.group_order} train wall_s={walls[label]:.3f} minibatches={n_steps} "
              f"ms_per_minibatch={1e3 * walls[label] / n_steps:.3f} peak_mem_gb={peaks[label]:.3f} "
              f"launches={json.dumps({n: c for n, c in launch.items() if c})}", flush=True)
        if metrics_out and not extra:
            rec.save(metrics_out)
        check_finite_run(label, rec)
        final_acc = np.asarray(rec.series["test_accuracy"][-1]["value"])
        chance = 1.0 / tr.fed.num_classes
        print(f"{label} accuracy {final_acc.round(4).tolist()} (chance {chance})", flush=True)
        if not np.all(final_acc > chance):
            fail(f"{label}: final accuracy {final_acc} not above chance {chance}")
        exp = expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs))
        gate_launches(label, launch, {
            names[0]: exp["forward"], names[1]: exp["backward"], names[2]: exp["backward"],
            **{n: 0 for n in fc.LAUNCHES if n not in names},
            **{name: exp["direction"] for name in cc.LAUNCHES}})
        if profile:
            print(f"{label} profile", flush=True)
            profile_epoch(tr)
        del tr
    return launches, walls, peaks


def phase_auto_crossover() -> dict:
    """Where flash overtakes dense attention on the card, the measurement
    behind 'auto' (the JAX package's crossover on a TPU: S = 1024 at
    'default', 2048 at 'highest'): the LM's attention core (32 sequences of
    4 heads, D 16, causal) forward and backward through autograd, dense
    (`ops/attention.py`, f32) against flash at each precision, at S 128
    (the shortest flash takes) to 2048; device ms of each and the ratio
    dense / flash."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc
    from federated_pytorch_test_tpu_torch.ops.attention import dense_attention

    out = {}
    for s in (128, 256, 512, 1024, 2048):
        gen = torch.Generator(device="cuda").manual_seed(s)
        q, k, v, do = (torch.randn(32, s, 4, 16, device="cuda", generator=gen) for _ in range(4))
        leaves = [t.requires_grad_(True) for t in (q, k, v)]

        def run(fn):
            def call():
                torch.autograd.grad(fn(*leaves), leaves, do)
            return time_ms(call, 10, queued=10)[1]

        dense = run(lambda *a: dense_attention(*a, causal=True))
        for prec in ("default", "highest"):
            flash = run(lambda *a: fc.flash_attention(*a, causal=True, precision=prec))
            out[(s, prec)] = {"dense_device_ms": dense, "flash_device_ms": flash}
            print(f"auto crossover S={s} precision={prec} dense_device_ms={dense:.4f} flash_device_ms={flash:.4f} "
                  f"dense_over_flash={dense / flash:.3f}", flush=True)
    return out


class plain_grouped:
    """Within the block, the grouped GEMM's three roles take their plain
    versions on the card too (`torch.bmm`): the plain side of
    `phase_vit_moe_parity`. The port itself has no such switch."""

    def __enter__(self):
        from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

        self.saved = {role: getattr(gg, role) for role in ("grouped_matmul_fwd", "grouped_matmul_dlhs",
                                                          "grouped_matmul_drhs")}
        gg.grouped_matmul_fwd = gg.grouped_matmul_plain
        gg.grouped_matmul_dlhs = lambda dc, w: gg.grouped_matmul_plain(dc, w.transpose(1, 2))
        gg.grouped_matmul_drhs = lambda x, dc: gg.grouped_matmul_plain(x.transpose(1, 2), dc)
        return self

    def __exit__(self, *exc):
        from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

        for role, fn in self.saved.items():
            setattr(gg, role, fn)


def phase_vit_moe_parity():
    """The MoE ViT's block-0 round (group 1: its experts train, the gradient
    crosses every block) step by step at batch 128 (32,768 tokens a client,
    5,120 slots an expert: the weight gradients split), plain against the
    kernels: before each L-BFGS step the plain side ('dense' attention, the
    grouped GEMM's plain version) and the kernel side ('flash', the grouped
    kernel) get the same parameters and optimizer state, taken from the
    plain trajectory. Losses, parameters and the dual residual agree within
    relative 1e-3."""
    import torch

    from federated_pytorch_test_tpu_torch.consensus import FedAvgState, fedavg_round
    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.engine.steps import client_train_step, epoch_batches, round_init
    from federated_pytorch_test_tpu_torch.optim import clone_state
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    source = synthetic_cifar(3 * 512, 100, seed=2)
    trs = {impl: Trainer(get_preset("fedavg", model="vit", model_kwargs={**VIT_MOE_KWARGS, "attn_impl": impl},
                                    batch=128, nloop=1, nadmm=1, max_groups=2, lbfgs_direction="pallas"),
                         verbose=False, source=source)
           for impl in ("dense", "flash")}
    plain = trs["dense"]
    gid = plain.group_order[1]
    ctxs = {impl: tr.ctx(gid) for impl, tr in trs.items()}
    flat = plain.flat.clone()
    state, _ = round_init(ctxs["dense"], flat)
    idx = plain.epoch_indices(0, gid, 0, 0)
    worst = {"train_loss": 0.0, "params": 0.0, "dual_residual": 0.0}
    gg.reset_launch_counts()
    for s, (imgs, labels) in enumerate(epoch_batches(plain.shard_imgs, plain.shard_labels, idx)):
        with plain_grouped():
            fd, sd, _, ld = client_train_step(ctxs["dense"], flat.clone(), clone_state(state), {}, imgs, labels,
                                              plain.mean, plain.std)
        ff, _, _, lf = client_train_step(ctxs["flash"], flat.clone(), clone_state(state), {}, imgs, labels,
                                         plain.mean, plain.std)
        xd, xf = plain.partition.extract(fd, gid), plain.partition.extract(ff, gid)
        step = {"train_loss": float(((lf - ld).abs() / ld.abs()).max()),
                "params": float((xf - xd).abs().max() / xd.abs().max())}
        print(f"vit_moe parity step {s} " + " ".join(f"{k}_rel={v:.3e}" for k, v in step.items()), flush=True)
        worst = {k: max(v, step.get(k, 0.0)) for k, v in worst.items()}
        if s == idx.shape[0] - 1:  # the averaging round after each last step
            duals = [float(fedavg_round(x, FedAvgState(z=torch.zeros_like(x[0])))[1]["dual_residual"])
                     for x in (xd, xf)]
            worst["dual_residual"] = abs(duals[1] - duals[0]) / duals[0]
        flat, state = fd, sd
    launches = dict(gg.LAUNCHES)
    print(f"vit_moe parity kernel-vs-plain per step ({idx.shape[0]} steps, group {gid}) "
          + " ".join(f"{k}_max_rel={v:.3e}" for k, v in worst.items()) + f" launches={json.dumps(launches)}",
          flush=True)
    if not max(worst.values()) <= 1e-3:
        fail(f"vit_moe parity: a step differs between the plain path and the kernels: {worst}")
    if not all(launches[k] > 0 for k in gg.ROLES):
        fail(f"vit_moe parity: the kernel side did not run every grouped kernel: {launches}")


def phase_vit_moe_train(metrics_out, profile: bool):
    """The switch-MoE ViT path at full width, through the entry points a user calls."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    cfg = get_preset("fedavg", model="vit", model_kwargs=VIT_MOE_KWARGS, nloop=1, nadmm=1, lbfgs_direction="pallas")
    t0 = time.perf_counter()
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(VIT_TRAIN, VIT_TEST, seed=0))
    g, c, c_eval, d, h = moe_shapes(cfg)
    print(f"vit_moe setup: K={cfg.n_clients} batch={cfg.batch} nadmm={cfg.nadmm} {cfg.model_kwargs} "
          f"moe_aux_coef={cfg.moe_aux_coef} tokens={tr.model.tokens} params={tr.n_params} groups={tr.group_order} "
          f"group_sizes={[tr.partition.group_size(i) for i in tr.group_order]} experts_x_clients={g} "
          f"capacity={c} eval_capacity={c_eval} steps/epoch={tr.fed.steps_per_epoch(cfg.batch)} "
          f"setup_s={time.perf_counter() - t0:.3f}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    for mod in (fc, cc, gg):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {**dict(fc.LAUNCHES), **dict(cc.LAUNCHES), **dict(gg.LAUNCHES)}

    for r in rec.series["step_time"]:
        if r["value"]["phase"] == "round":
            print(f"vit_moe round group={r['group']} wall_s={r['value']['seconds']:.3f}", flush=True)
    n_steps = len(rec.series["train_loss"])
    print(f"vit_moe train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={peak:.3f} launches={json.dumps(launches)}", flush=True)
    if metrics_out:
        rec.save(metrics_out)

    all_losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    if not np.all(np.isfinite(all_losses)) or rec.first_nonfinite is not None:
        fail(f"vit_moe: non-finite training loss: {rec.first_nonfinite}")
    accs = [(r["group"], np.asarray(r["value"])) for r in rec.series["test_accuracy"]]
    print("vit_moe accuracy per group " + " ".join(f"{g}:{','.join(f'{a:.4f}' for a in v)}" for g, v in accs),
          flush=True)
    chance = 1.0 / tr.fed.num_classes
    if not np.all(accs[-1][1] > chance):
        fail(f"vit_moe final accuracy {accs[-1][1]} not above chance {chance}")
    for name in (*fc.RECT_KERNELS, *gg.ROLES):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the MoE ViT path")
    exp = expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs))  # an evaluation: one pass a test batch
    gate_launches("vit_moe", launches, {"flash_fwd_rect": exp["forward"], "flash_bwd_dq_rect": exp["backward"],
                                        "flash_bwd_dkv_rect": exp["backward"],
                                        **{name: exp["direction"] for name in cc.LAUNCHES},
                                        **expected_grouped(exp, cfg)})
    if profile:
        profile_epoch(tr, tr.group_order[1])
    return launches, wall, peak


def phase_vit_moe_bf16_train(metrics_out, f32_wall: float, f32_peak: float):
    """14″. Phase 14's switch-MoE ViT path at compute_dtype bf16 with
    attention at 'default' (`VIT_MOE_BF16_KWARGS`): the experts on the bf16
    grouped kernel, the one-pass rectangular flash kernels. Launches of the
    bf16 grouped roles, the one-pass flash kernels and the compact pair
    gated exactly (the f32 grouped roles and split flash kernels at 0);
    losses finite, every client above chance; wall and peak printed beside
    phase 14's f32 run."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    cfg = get_preset("fedavg", model="vit", model_kwargs=VIT_MOE_BF16_KWARGS, nloop=1, nadmm=1,
                     lbfgs_direction="pallas", compute_dtype="bfloat16")
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(VIT_TRAIN, VIT_TEST, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (fc, cc, gg):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {**dict(fc.LAUNCHES), **dict(cc.LAUNCHES), **dict(gg.LAUNCHES)}
    n_steps = len(rec.series["train_loss"])
    print(f"vit_moe bf16 train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={peak:.3f} f32_wall_s={f32_wall:.3f} f32_peak_mem_gb={f32_peak:.3f} "
          f"launches={json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    if metrics_out:
        rec.save(metrics_out)
    all_losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    if not np.all(np.isfinite(all_losses)) or rec.first_nonfinite is not None:
        fail(f"vit_moe bf16: non-finite training loss: {rec.first_nonfinite}")
    accs = [(r["group"], np.asarray(r["value"])) for r in rec.series["test_accuracy"]]
    print("vit_moe bf16 accuracy per group " + " ".join(f"{g}:{','.join(f'{a:.4f}' for a in v)}" for g, v in accs),
          flush=True)
    if not np.all(accs[-1][1] > 1.0 / tr.fed.num_classes):
        fail(f"vit_moe bf16: final accuracy {accs[-1][1]} not above chance")
    for name in gg.BF16_ROLES:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the bf16 MoE ViT path")
    exp = expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs))
    gate_launches("vit_moe bf16", launches, {
        "flash_fwd_rect_1pass": exp["forward"], "flash_bwd_dq_rect_1pass": exp["backward"],
        "flash_bwd_dkv_rect_1pass": exp["backward"], **{name: 0 for name in fc.RECT_KERNELS},
        **{name: exp["direction"] for name in cc.LAUNCHES}, **expected_grouped(exp, cfg)})
    return launches, wall, peak


def check_finite_run(path: str, rec) -> None:
    """Every loss and residual of the run finite."""
    import numpy as np

    for name in ("train_loss", "primal_residual", "dual_residual"):
        vals = np.asarray([r["value"] for r in rec.series.get(name, [])], dtype=np.float64)
        if not np.all(np.isfinite(vals)):
            fail(f"{path}: non-finite {name}")
    if rec.first_nonfinite is not None:
        fail(f"{path}: non-finite {rec.first_nonfinite}")


def phase_admm_train(metrics_out, profile: bool):
    """The admm path: the admm preset (Net, K=3, batch 512, nadmm 5, BB rho)
    through the entry points a user calls."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc

    cfg = get_preset("admm", nloop=1, lbfgs_direction="pallas")
    t0 = time.perf_counter()
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(50_000, 10_000, seed=0))
    print(f"admm setup: {cfg.model} K={cfg.n_clients} batch={cfg.batch} nadmm={cfg.nadmm} bb={cfg.bb_update} "
          f"rho0={cfg.admm_rho0} groups={tr.group_order} params={tr.n_params} "
          f"steps/epoch={tr.fed.steps_per_epoch(cfg.batch)} setup_s={time.perf_counter() - t0:.3f}", flush=True)

    cc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cc.LAUNCHES)

    rounds = {(r["group"], r["nadmm"]): r["value"] for r in rec.series["mean_rho"]}
    primal = {(r["group"], r["nadmm"]): r["value"] for r in rec.series["primal_residual"]}
    dual = {(r["group"], r["nadmm"]): r["value"] for r in rec.series["dual_residual"]}
    for gid in tr.group_order:
        traj = [rounds[(gid, a)] for a in range(cfg.nadmm)]
        print(f"admm rho group={gid} mean_rho_per_round={','.join(f'{v:.6g}' for v in traj)} "
              f"final_rho={','.join(f'{v:.6g}' for v in tr._rho_store[gid][:, 0].tolist())} "
              f"primal={','.join(f'{primal[(gid, a)]:.3e}' for a in range(cfg.nadmm))} "
              f"dual={','.join(f'{dual[(gid, a)]:.3e}' for a in range(cfg.nadmm))}", flush=True)
        for rho in tr._rho_store[gid][:, 0].tolist():
            # rho0, or an accepted BB value: positive and below bb_rhomax
            if not (np.isclose(rho, cfg.admm_rho0, rtol=1e-6) or 0.0 < rho < cfg.bb_rhomax):
                fail(f"admm: group {gid} ended with rho {rho}, neither rho0 nor an accepted BB value")
    n_steps = len(rec.series["train_loss"])
    print(f"admm train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"launches={json.dumps(launches)}", flush=True)
    if metrics_out:
        rec.save(metrics_out)

    check_finite_run("admm", rec)
    final_acc = np.asarray(rec.series["test_accuracy"][-1]["value"])
    print(f"admm final accuracy {final_acc.round(4).tolist()}", flush=True)
    chance = 1.0 / tr.fed.num_classes
    if not np.all(final_acc > chance):
        fail(f"admm final accuracy {final_acc} not above chance {chance}")
    gate_launches("admm", launches, {name: expected_launches(rec)["direction"] for name in cc.LAUNCHES})
    if profile:
        profile_epoch(tr)
    return launches, wall


class direction_f64:
    """Within the block, the L-BFGS direction 'compact_f64' is the plain
    compact direction computed in float64 and rounded back to float32: the
    plain side of `phase_resnet_parity`. At N = 4.7M the float32 plain
    version's `matmul` sums are less exact than the kernel's (its
    direction strays up to ~1e-4 from float64 in the first steps, the
    kernel's ~5e-7), so the kernel is held against the plain version in
    float64, as the flash kernels are at large scores. With `probe`, the
    'pallas' direction also prints, per call, how far the kernel's and the
    float32 plain direction lie from float64. The port itself has no such
    switch."""

    def __init__(self, probe: bool = False):
        self.probe = probe

    def __enter__(self):
        from federated_pytorch_test_tpu_torch.optim import lbfgs
        from federated_pytorch_test_tpu_torch.optim.compact import compact_direction

        def f64(g, s, y, count, h_diag):
            return compact_direction(g.double(), s.double(), y.double(), count, h_diag.double()).float()

        def probed(g, s, y, count, h_diag):
            d = self.kernel(g, s, y, count, h_diag)
            ref = compact_direction(g.double(), s.double(), y.double(), count, h_diag.double())
            scale = ref.abs().amax(1)
            errs = {"kernel": (d.double() - ref).abs().amax(1) / scale,
                    "plain_f32": (compact_direction(g, s, y, count, h_diag).double() - ref).abs().amax(1) / scale}
            print(f"resnet direction count={count.tolist()} " + " ".join(
                f"{k}_vs_f64={','.join(f'{v:.2e}' for v in e.tolist())}" for k, e in errs.items()), flush=True)
            return d

        self.directions = lbfgs.DIRECTIONS
        self.saved = dict(self.directions)  # restored on exit, so the blocks nest
        self.kernel = self.directions["pallas"]
        self.directions["compact_f64"] = f64
        if self.probe:
            self.directions["pallas"] = probed
        return self

    def __exit__(self, *exc):
        self.directions.clear()
        self.directions.update(self.saved)


def phase_resnet_parity():
    """admm_resnet's block7 round (group 8, N = 4,720,640 a client, the
    largest group) at full width, step by step: before each L-BFGS step the
    plain side (the compact direction in float64, `direction_f64`) and the
    kernel side ('pallas') get the same parameters, BatchNorm statistics,
    optimizer state and ADMM state, taken from the plain trajectory; after
    each ADMM round's last step both sides' consensus runs from the same
    ADMM state. The first step also prints each direction's distance from
    float64, the kernel's and the float32 plain version's. cuDNN is
    deterministic (the port's default), so that the two sides differ by
    their directions and not by the convolutions' run-to-run rounding."""
    import dataclasses

    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.engine.steps import admm_consensus, client_train_step, epoch_batches, round_init
    from federated_pytorch_test_tpu_torch.optim import clone_state

    cfg = get_preset("admm_resnet", nloop=1, lbfgs_direction="pallas")
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(RESNET_TRAIN, 100, seed=1))
    gid = 8
    ctx = tr.ctx(gid)
    flat, stats = tr.flat.clone(), dict(tr.stats)
    state, cstate = round_init(ctx, flat)
    worst = {"train_loss": 0.0, "params": 0.0, "stats": 0.0, "primal_residual": 0.0, "dual_residual": 0.0}
    n_steps = 0
    t0 = time.perf_counter()
    with direction_f64():
        ctxs = {"plain": dataclasses.replace(ctx, lbfgs=dataclasses.replace(ctx.lbfgs, direction="compact_f64")),
                "pallas": ctx}
        for a in range(cfg.nadmm):
            idx = tr.epoch_indices(0, gid, a, 0)
            for imgs, labels in epoch_batches(tr.shard_imgs, tr.shard_labels, idx):
                out = {}
                for d, c in ctxs.items():
                    with direction_f64(probe=n_steps == 0 and d == "pallas"):
                        out[d] = client_train_step(c, flat.clone(), clone_state(state), stats, imgs, labels,
                                                   tr.mean, tr.std, cstate)
                (fc, sc, stc, lc), (fp, _, stp, lp) = out["plain"], out["pallas"]
                xc, xp = tr.partition.extract(fc, gid), tr.partition.extract(fp, gid)
                step = {"train_loss": float(((lp - lc).abs() / lc.abs()).max()),
                        "params": float((xp - xc).abs().max() / xc.abs().max()),
                        "stats": max(float((stp[n] - t).abs().max() / t.abs().max()) for n, t in stc.items())}
                if n_steps < 2:
                    print(f"resnet parity step {n_steps} " + " ".join(f"{k}_rel={v:.3e}" for k, v in step.items()),
                          flush=True)
                worst = {k: max(v, step.get(k, 0.0)) for k, v in worst.items()}
                flat, state, stats = fc, sc, stc
                n_steps += 1
            mets = [admm_consensus(ctx, f, cstate, a) for f in (flat, fp)]
            for name in ("primal_residual", "dual_residual"):
                ref = float(mets[0][1][name])
                worst[name] = max(worst[name], abs(float(mets[1][1][name]) - ref) / abs(ref))
            cstate = mets[0][0]
    torch.cuda.synchronize()
    print(f"resnet parity pallas-vs-plain(f64) group={gid} N={tr.partition.group_size(gid)} per step ({n_steps} steps, "
          f"{time.perf_counter() - t0:.1f} s) " + " ".join(f"{k}_max_rel={v:.3e}" for k, v in worst.items()),
          flush=True)
    if not max(worst.values()) <= 1e-3:
        fail(f"resnet parity: a step differs between the plain (float64) and kernel directions: {worst}")


def resnet_train_run(preset: str, source, **overrides):
    """One ResNet preset's run at full width with the kernels' launches
    counted; gated exactly, losses, residuals and statistics checked."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc

    cfg = get_preset(preset, nloop=1, lbfgs_direction="pallas", **overrides)
    t0 = time.perf_counter()
    tr = Trainer(cfg, verbose=False, source=source)
    init_stats = {n: t.clone() for n, t in tr.stats.items()}
    print(f"{preset} setup: K={cfg.n_clients} batch={cfg.batch} nadmm={cfg.nadmm} groups={tr.group_order} "
          f"params={tr.n_params} sizes={[tr.partition.group_size(g) for g in tr.group_order]} "
          f"steps/epoch={tr.fed.steps_per_epoch(cfg.batch)} setup_s={time.perf_counter() - t0:.3f}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    cc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cc.LAUNCHES)

    for r in rec.series["step_time"]:
        if r["value"]["phase"] == "round":
            print(f"{preset} round group={r['group']} N={tr.partition.group_size(r['group'])} "
                  f"wall_s={r['value']['seconds']:.3f}", flush=True)
    accs = [(r["group"], r["nadmm"], r["value"]) for r in rec.series["test_accuracy"]]
    print(f"{preset} accuracy per round " + " ".join(f"{g}/{a}:{','.join(f'{v:.4f}' for v in vals)}"
                                                   for g, a, vals in accs), flush=True)
    n_steps = len(rec.series["train_loss"])
    print(f"{preset} train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={json.dumps(launches)}", flush=True)

    check_finite_run(preset, rec)
    moved = sum(not torch.equal(t, init_stats[n]) for n, t in tr.stats.items())
    finite = all(bool(torch.isfinite(t).all()) for t in tr.stats.values())
    print(f"{preset} batchnorm statistics: {moved} of {len(tr.stats)} moved, finite={finite}", flush=True)
    if not finite or moved != len(tr.stats):
        fail(f"{preset}: BatchNorm running statistics non-finite or unmoved ({moved} of {len(tr.stats)} moved)")
    gate_launches(preset, launches, {name: expected_launches(rec)["direction"] for name in cc.LAUNCHES})
    return tr, rec, launches, wall


def phase_resnet_train(metrics_out, profile: bool):
    """The ResNet paths at full width: admm_resnet over all ten groups in
    the preset's shuffled order, then fedavg_resnet over its first three;
    then both compact kernels at every group size the paths reached."""
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.optim.compact import compact_solves, history_valid

    print(f"reduced resnet: {RESNET_TRAIN} train images of 50,000 (synthetic stand-in), {RESNET_TEST} test images "
          f"of 10,000, one outer loop of 12", flush=True)
    source = synthetic_cifar(RESNET_TRAIN, RESNET_TEST, seed=0)
    tr, rec, launches, wall = resnet_train_run("admm_resnet", source)
    if metrics_out:
        rec.save(metrics_out)
    if profile:
        profile_epoch(tr, gid=8)
    ftr, _, f_launches, f_wall = resnet_train_run("fedavg_resnet", source, max_groups=3, nadmm=1)

    sizes = sorted({tr.partition.group_size(g) for g in tr.group_order})
    times = {}
    for n in sizes:
        s, y, g, count, h_diag = history(n, seed=n)
        sy, yy, p, q = cc.fused_gram_projections_plain(s, y, g, count)
        u, w, _, _ = compact_solves(sy, p, q, history_valid(count, M), h_diag,
                                    lambda uu: (torch.matmul(yy, uu[..., None])[..., 0], None))
        errs = {"gram": max(rel_err(a, b) for a, b in zip(cc.fused_gram_projections(s, y, g, count), (sy, yy, p, q))),
                "assembly": rel_err(cc.fused_direction_assembly(s, y, g, w, u, h_diag, count),
                                    cc.fused_direction_assembly_plain(s, y, g, w, u, h_diag, count))}
        print(f"resnet kernels N={n} " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
        if not max(errs.values()) <= RTOL:
            fail(f"compact kernel disagrees with its plain version at the ResNet size N={n}: {errs}")
        rows = compact_timings(s, y, g, w, u, h_diag, n)
        times[n] = {name: {k: r[k] for k in ("device_ms", "bound_ms", "library_device_ms", "plain_device_ms")}
                    for name, r in rows.items()}
        del s, y, g
    return {"admm_resnet": launches, "fedavg_resnet": f_launches}, {"admm_resnet": wall, "fedavg_resnet": f_wall}, times


def phase_no_consensus_train(metrics_out, profile: bool):
    """The no_consensus path: independent Net1 clients, the whole vector
    (N = 890,410) one group, the elastic net on fc1 only, each client its
    own initial draw, through the entry points a user calls.

    The port's deterministic cuDNN gives the phase one trajectory on every
    run. With cuDNN's default algorithms two runs differ from the first
    step on, and the memorizing clients' trajectories part: on some of them
    a client reaches the optimizer's non-finite mode, which the JAX package
    and the reference share (`no_consensus_probe.py --nondeterministic`
    finds and replays it): curvature pairs with y·y near 1e-17 set a huge
    h_diag, the next hard minibatch's direction overflows the forward, and
    the Armijo test, false for a NaN loss, accepts the step."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import normalize, synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.engine.steps import data_loss, objective
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.partition import unflatten_params

    cfg = get_preset("no_consensus", lbfgs_direction="pallas", nepoch=NO_CONSENSUS_EPOCHS)
    print(f"reduced no_consensus nepoch={cfg.nepoch} of the preset's {get_preset('no_consensus').nepoch}: "
          "the script's time", flush=True)
    t0 = time.perf_counter()
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(50_000, 10_000, seed=0))
    print(f"no_consensus setup: {cfg.model} K={cfg.n_clients} batch={cfg.batch} nepoch={cfg.nepoch} "
          f"params={tr.n_params} groups={[tr.partition.group_size(g) for g in tr.group_order]} "
          f"reg_segments={[(s.start, s.size) for s in tr.ctx(0).reg_segments]} "
          f"steps/epoch={tr.fed.steps_per_epoch(cfg.batch)} setup_s={time.perf_counter() - t0:.3f}", flush=True)
    flat0 = tr.flat.clone()

    torch.cuda.reset_peak_memory_stats()
    cc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cc.LAUNCHES)

    epochs = [r for r in rec.series["step_time"] if r["value"]["phase"] == "epoch"]
    for r, acc in zip(epochs, [r for r in rec.series["test_accuracy"] if "epoch" in r]):
        losses = np.asarray([x["value"] for x in rec.series["train_loss"] if x["epoch"] == r["epoch"]])
        print(f"no_consensus epoch={r['epoch']} wall_s={r['value']['seconds']:.3f} "
              f"mean_loss={','.join(f'{v:.4e}' for v in losses.mean(0))} "
              f"acc={','.join(f'{a:.4f}' for a in acc['value'])}", flush=True)
    n_steps = len(rec.series["train_loss"])
    print(f"no_consensus train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={json.dumps(launches)}", flush=True)
    if metrics_out:
        rec.save(metrics_out)

    check_finite_run("no_consensus", rec)
    final_acc = np.asarray(rec.series["test_accuracy"][-1]["value"])
    chance = 1.0 / tr.fed.num_classes
    print(f"no_consensus final accuracy {final_acc.round(4).tolist()}", flush=True)
    if not np.all(final_acc > chance):
        fail(f"no_consensus final accuracy {final_acc} not above chance {chance}")
    # independent training: the clients started apart and stay apart
    apart = [float((tr.flat[a] - tr.flat[b]).abs().max()) for a in range(3) for b in range(a)]
    moved = (tr.flat - flat0).abs().amax(1).tolist()
    print(f"no_consensus clients pairwise_max_abs_diff={','.join(f'{d:.3e}' for d in apart)} "
          f"moved_from_init={','.join(f'{d:.3e}' for d in moved)}", flush=True)
    if not min(apart) > 0 or not min(moved) > 0:
        fail("no_consensus: clients share their parameters or did not move")

    # one step's objective against data loss + l1·|fc1|₁ + l2·|fc1|² computed apart (float64)
    ctx = tr.ctx(0)
    idx = tr.epoch_indices(0, 0, 0, 0)[0]
    rows = torch.arange(3, device="cuda")[:, None]
    idx_t = torch.as_tensor(idx, device="cuda")
    images = normalize(tr.shard_imgs[rows, idx_t], tr.mean, tr.std)
    labels = tr.shard_labels[rows, idx_t]
    with torch.no_grad():
        loss, _, _ = objective(ctx, tr.flat, tr.flat, {}, images, labels)
        params = unflatten_params(tr.flat, tr.shapes)
        dl = data_loss(ctx, params, images, labels).double()
        fc1 = torch.cat([params["fc1.weight"].flatten(1), params["fc1.bias"]], 1).double()
        ref = dl + cfg.lambda1 * fc1.abs().sum(1) + cfg.lambda2 * (fc1 * fc1).sum(1)
    (seg,) = ctx.reg_segments
    err = float(((loss.double() - ref).abs() / ref.abs()).max())
    print(f"no_consensus objective fc1_coords={fc1.shape[1]} segment=({seg.start},{seg.size}) "
          f"objective={','.join(f'{v:.6e}' for v in loss.tolist())} apart={','.join(f'{v:.6e}' for v in ref.tolist())} "
          f"max_rel={err:.3e}", flush=True)
    if fc1.shape[1] != seg.size or not err <= 1e-5:
        fail(f"no_consensus: the objective is not data loss + the fc1 elastic net ({err:.3e})")
    gate_launches("no_consensus", launches, {name: expected_launches(rec)["direction"] for name in cc.LAUNCHES})
    if profile:
        # the kernel mix is the same every minibatch; the profiler's summary
        # of a whole 520-minibatch epoch takes most of the call
        print(f"reduced no_consensus profile minibatches={NO_CONSENSUS_PROFILE_STEPS} of "
              f"{tr.fed.steps_per_epoch(cfg.batch)}: the profiler's time", flush=True)
        profile_epoch(tr, max_steps=NO_CONSENSUS_PROFILE_STEPS)
    return launches, wall


def phase_compact_no_consensus() -> dict:
    """Both compact kernels at the no_consensus path's N = 890,410, and at
    890,408 beside it (rows 16-byte aligned), against the plain version in
    float64 (at this N the float32 plain version's sums are no reference,
    as at the ResNet sizes) and timed; the plain `two_loop` direction at
    48,120 and 890,410 against the plain compact direction in float64,
    timed beside the kernel direction. Returns the kernels' rows by N
    (890,410 and 890,408)."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.optim.compact import compact_direction, compact_solves, history_valid
    from federated_pytorch_test_tpu_torch.optim.lbfgs import _two_loop_direction

    def rel64(out, ref):
        return float((out.double() - ref).abs().max() / ref.abs().max())

    rows = {}
    for n in (REPORT_N, NO_CONSENSUS_N, ALIGNED_NO_CONSENSUS_N):
        s, y, g, count, h_diag = history(n, seed=n)
        if n != REPORT_N:
            gram = cc.fused_gram_projections(s, y, g, count)
            ref = cc.fused_gram_projections_plain(s.double(), y.double(), g.double(), count)
            sy, yy, p, q = ref
            u, w, _, _ = compact_solves(sy, p, q, history_valid(count, M), h_diag.double(),
                                        lambda uu: (torch.matmul(yy, uu[..., None])[..., 0], None))
            asm = cc.fused_direction_assembly(s, y, g, w.float(), u.float(), h_diag, count)
            asm_ref = cc.fused_direction_assembly_plain(s.double(), y.double(), g.double(), w, u, h_diag.double(), count)
            direction = cc.compact_direction_cuda(g, s, y, count, h_diag)
            dir_ref = compact_direction(g.double(), s.double(), y.double(), count, h_diag.double())
            errs = {**{f"gram.{nm}": rel64(a, b) for nm, a, b in zip(("sy", "yy", "p", "q"), gram, ref)},
                    "assembly": rel64(asm, asm_ref), "direction": rel64(direction, dir_ref)}
            print(f"no_consensus kernels N={n} vs_f64 " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
            if not max(errs.values()) <= RTOL:
                fail(f"compact kernel disagrees with its plain version in float64 at N={n}: {errs}")
            u, w = u.float(), w.float()
            del ref, asm_ref
        if n == ALIGNED_NO_CONSENSUS_N:
            rows[n] = compact_timings(s, y, g, w, u, h_diag, n)
            del s, y, g
            continue
        s.nan_to_num_(0.0)
        y.nan_to_num_(0.0)
        full = torch.full((K,), M, dtype=torch.int32, device="cuda")
        for cnt in (count, full):
            two = _two_loop_direction(g, s, y, cnt, h_diag)
            ref = compact_direction(g.double(), s.double(), y.double(), cnt, h_diag.double())
            err = rel64(two, ref)
            print(f"two_loop N={n} count={cnt.tolist()} vs_compact_f64={err:.3e}", flush=True)
            if not err <= RTOL:
                fail(f"two_loop direction disagrees with the compact direction in float64 at N={n}: {err:.3e}")
        # a direction call launches up to ~120 kernels (two_loop): queue
        # few calls, or the launch queue fills (`time_ms`)
        iters = 20 if n > 200_000 else 200
        t_two = time_ms(lambda: _two_loop_direction(g, s, y, full, h_diag), iters, queued=4)
        t_kernel = time_ms(lambda: cc.compact_direction_cuda(g, s, y, full, h_diag), iters, queued=4)
        t_plain = time_ms(lambda: compact_direction(g, s, y, full, h_diag), iters, queued=4)
        print(f"timing direction N={n} K={K} m={M} two_loop_ms={t_two[0]:.6f} two_loop_device_ms={t_two[1]:.6f} "
              f"kernel_ms={t_kernel[0]:.6f} kernel_device_ms={t_kernel[1]:.6f} "
              f"compact_plain_ms={t_plain[0]:.6f} compact_plain_device_ms={t_plain[1]:.6f}", flush=True)
        if n == NO_CONSENSUS_N:
            rows[n] = compact_timings(s, y, g, w, u, h_diag, n)
            for r in rows[n].values():
                r["two_loop_ms"], r["two_loop_device_ms"] = t_two
                r["direction_ms"], r["direction_device_ms"] = t_kernel
        del s, y, g
    return rows


def bitwise_equal(a, b) -> bool:
    """Equal bits (NaN included), for float32 or bfloat16 tensors or nested lists of floats."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))
    x, z = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return x.shape == z.shape and np.array_equal(x.view(np.int64), z.view(np.int64))


def resume_pair(label: str, preset: str, source, ckpt_dir: str, **overrides) -> None:
    """`preset` run for two outer loops straight, and for one loop with
    `save_model` then a fresh Trainer with `load_model=True, nloop=2`: the
    final parameters, the rho store and the loop-1 series must be bitwise
    equal. The largest differences are printed either way."""
    import torch

    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset

    cfg = get_preset(preset, lbfgs_direction="pallas", **overrides)
    t0 = time.perf_counter()
    tr_a = Trainer(cfg.replace(nloop=2, checkpoint_dir=os.path.join(ckpt_dir, "a")), verbose=False, source=source)
    rec_a = tr_a.run()
    cfg_b = cfg.replace(nloop=1, save_model=True, checkpoint_dir=os.path.join(ckpt_dir, "b"))
    Trainer(cfg_b, verbose=False, source=source).run()
    tr_b = Trainer(cfg_b.replace(nloop=2, save_model=False, load_model=True), verbose=False, source=source)
    restored = tr_b._completed_nloops
    rec_b = tr_b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    names = ["train_loss", "dual_residual", "test_accuracy"] + (["primal_residual", "mean_rho"]
                                                                 if cfg.strategy == "admm" else [])
    same = {"flat": bitwise_equal(tr_a.flat, tr_b.flat),
            "rho_store": sorted(tr_a._rho_store) == sorted(tr_b._rho_store)
            and all(bitwise_equal(r, tr_b._rho_store[g]) for g, r in tr_a._rho_store.items())}
    diffs = {"flat": float((tr_a.flat - tr_b.flat).abs().max())}
    for name in names:
        a = [r["value"] for r in rec_a.series[name] if r["nloop"] == 1]
        b = [r["value"] for r in rec_b.series[name]]
        same[name] = bool(a) and bitwise_equal(a, b)
        diffs[name] = max((abs(x - z) for x, z in zip(torch.tensor(a).flatten().tolist(),
                                                      torch.tensor(b).flatten().tolist())), default=float("nan"))
    rho = {g: r[:, 0].tolist() for g, r in tr_a._rho_store.items()}
    print(f"resume {label} restored_nloops={restored} records={len(rec_b.series['train_loss'])} rho={rho} "
          f"wall_s={wall:.3f} " + " ".join(f"{k}_bitwise={v}" for k, v in same.items()) + " "
          + " ".join(f"{k}_max_abs_diff={v:.3e}" for k, v in diffs.items()), flush=True)
    if restored != 1 or not all(same.values()):
        fail(f"resume {label}: the resumed run differs from the uninterrupted one: {same} {diffs}")


def phase_resume():
    """A resumed run against the uninterrupted one on the card, bit for bit:
    fedavg (Net, two groups) and admm (Net's first group, nadmm 5, BB with
    its thresholds opened so that it accepts a proposal and the second
    loop starts from the restored rho), the kernel direction, under the
    port's defaults (deterministic cuDNN, as every entry point sets it)."""
    import tempfile

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar

    print(f"reduced resume train images={RESUME_TRAIN} of 50,000 (8 minibatches of 512 a client): the script's time",
          flush=True)
    source = synthetic_cifar(RESUME_TRAIN, 10_000, seed=0)
    with tempfile.TemporaryDirectory() as d:
        resume_pair("fedavg", "fedavg", source, os.path.join(d, "fedavg"), max_groups=2)
        resume_pair("admm", "admm", source, os.path.join(d, "admm"), max_groups=1, nadmm=5, bb_update=True,
                    bb_epsilon=1e-12, bb_rhomax=1e6)


REPEAT_TEST = 1_000  # test images of the repeat phase's runs (each round ends in an evaluation)


def repeat_pair(label: str, run) -> float:
    """`run()` (a fresh run of one round, returning its final parameters and
    loss series) twice under the port's defaults: both bitwise equal. The
    largest parameter difference is printed either way; returns the wall of
    one run."""
    import torch

    walls, outs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        outs.append(run())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    (flat_a, loss_a), (flat_b, loss_b) = outs
    same = {"params": bitwise_equal(flat_a, flat_b), "train_loss": bitwise_equal(loss_a, loss_b)}
    print(f"repeat {label} params={flat_a.numel()} minibatches={len(loss_a)} "
          + " ".join(f"{k}_bitwise={v}" for k, v in same.items())
          + f" params_max_abs_diff={float((flat_a - flat_b).abs().max()):.3e} wall_s={walls[0]:.3f},{walls[1]:.3f}",
          flush=True)
    if not all(same.values()):
        fail(f"repeat {label}: two runs under the port's defaults differ: {same}")
    return walls[0]


def phase_repeat() -> dict:
    """The first round of each train path run twice under the port's
    defaults (deterministic cuDNN, `utils/device.py`), each run a fresh
    Trainer: final parameters and loss series bitwise equal. Net fedavg and
    admm_resnet train conv1 (group 0), whose weight gradient cuDNN's default
    algorithms add in an order that changes from run to run; the LM its
    embedding (the attention backward in every block); the ViT, and the
    MoE ViT at f32 and bf16, block0 (every block's backward, the experts'
    weight gradients in block0). Returns the wall of one run a path."""
    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.federated_lm import FederatedLM, LMConfig

    print(f"reduced repeat test images={REPEAT_TEST} of 10,000; one round a path: the script's time", flush=True)

    def trainer_round(cfg, source, gid):
        def run():
            tr = Trainer(cfg, verbose=False, source=source)
            tr.group_order = [gid]
            rec = tr.run()
            return tr.flat, [r["value"] for r in rec.series["train_loss"]]
        return run

    def lm_round():
        lm = FederatedLM(LMConfig(max_groups=1), verbose=False)
        rec = lm.run()
        return lm.flat, [r["value"] for r in rec.series["train_loss"]]

    walls = {}
    one_round = dict(nloop=1, nadmm=1, lbfgs_direction="pallas")
    walls["fedavg"] = repeat_pair("fedavg conv1", trainer_round(
        get_preset("fedavg", **one_round), synthetic_cifar(50_000, REPEAT_TEST, seed=0), 0))
    walls["admm_resnet"] = repeat_pair("admm_resnet conv1", trainer_round(
        get_preset("admm_resnet", **one_round), synthetic_cifar(RESNET_TRAIN, REPEAT_TEST, seed=0), 0))
    walls["lm"] = repeat_pair("lm embedding", lm_round)
    vit_source = synthetic_cifar(VIT_TRAIN, REPEAT_TEST, seed=0)
    for label, kwargs, dtype in (("vit", VIT_KWARGS, "float32"), ("vit_moe", VIT_MOE_KWARGS, "float32"),
                                 ("vit_moe_bf16", VIT_MOE_BF16_KWARGS, "bfloat16")):
        walls[label] = repeat_pair(f"{label} block0", trainer_round(
            get_preset("fedavg", model="vit", model_kwargs=kwargs, compute_dtype=dtype, **one_round), vit_source, 1))
    return walls


def scale64_run(preset: str, gid: int, nadmm: int, source):
    """One round of group `gid` of a scale64 preset (K=64 ResNet18 clients
    on CIFAR-100) at full width with the kernels' launches counted: gated
    exactly; losses, residuals and BatchNorm statistics checked; the peak
    of allocated device memory, from before the Trainer was built, below
    the card's memory."""
    import torch

    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc

    cfg = get_preset(preset, nloop=1, nadmm=nadmm, lbfgs_direction="pallas")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, verbose=False, source=source)
    tr.group_order = [gid]
    init_stats = {n: t.clone() for n, t in tr.stats.items()}
    print(f"{preset} setup: K={cfg.n_clients} batch={cfg.batch} nadmm={nadmm} group={gid} "
          f"N={tr.partition.group_size(gid)} params={tr.n_params} classes={tr.fed.num_classes} "
          f"shard={tr.fed.shard_size} steps/epoch={tr.fed.steps_per_epoch(cfg.batch)} "
          f"setup_s={time.perf_counter() - t0:.3f}", flush=True)
    cc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    n_steps = len(rec.series["train_loss"])
    passes = rec.series["objective_passes"][-1]["value"]
    print(f"{preset} train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={peak / 1e9:.3f} device_mem_gb={total / 1e9:.3f} passes={json.dumps(passes)} "
          f"launches={json.dumps(launches)}", flush=True)
    last = [r["value"] for r in rec.series["train_loss"]][-1]
    print(f"{preset} last train_loss min={min(last):.6e} max={max(last):.6e}", flush=True)
    check_finite_run(preset, rec)
    moved = sum(not torch.equal(t, init_stats[n]) for n, t in tr.stats.items())
    finite = all(bool(torch.isfinite(t).all()) for t in tr.stats.values())
    print(f"{preset} batchnorm statistics: {moved} of {len(tr.stats)} moved, finite={finite}", flush=True)
    if not finite or moved != len(tr.stats):
        fail(f"{preset}: BatchNorm running statistics non-finite or unmoved ({moved} of {len(tr.stats)} moved)")
    if not peak < total:
        fail(f"{preset}: peak allocated memory {peak} not below the card's {total}")
    gate_launches(preset, launches, {name: expected_launches(rec)["direction"] for name in cc.LAUNCHES})
    return rec, launches, wall, peak


def scale64_kernels(n: int) -> dict:
    """Both compact kernels at K=64, m=10 and N = `n` on a seeded history
    (full for the timings; for the check, client 31 holds 3 pairs and a
    NaN-filled invalid row, client 63 seven): clients 0, 31 and 63 against
    the plain version computed in float64 (relative 1e-5 of the largest
    reference entry; a float64 history of all 64 clients would not fit);
    device ms beside the bytes bound and the `matmul` yardstick on the
    history stacked as one `[K, 2m+1, N]` tensor. Returns the rows."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.optim.compact import compact_solves, history_valid

    k = SCALE64_K
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.empty((k, 2 * M + 1, n), device="cuda")
    x[:, :M].normal_(0.0, 0.1, generator=gen)
    d = 0.5 + 1.5 * torch.rand(k, 1, n, device="cuda", generator=gen)
    x[:, M : 2 * M] = x[:, :M] * d + 0.01 * torch.randn(k, M, n, device="cuda", generator=gen)
    x[:, 2 * M].normal_(generator=gen)
    del d
    s, y, g = x[:, :M].contiguous(), x[:, M : 2 * M].contiguous(), x[:, 2 * M].contiguous()
    count = torch.full((k,), M, dtype=torch.int32, device="cuda")
    count[31], count[63] = 3, 7
    s[31, 5], y[31, 5] = float("nan"), float("nan")
    h_diag = 0.5 + torch.rand(k, device="cuda", generator=gen)
    gram = cc.fused_gram_projections(s, y, g, count)
    sy, yy, p, q = gram
    u, w, _, _ = compact_solves(sy, p, q, history_valid(count, M), h_diag,
                                lambda uu: (torch.matmul(yy, uu[..., None])[..., 0], None))
    asm = cc.fused_direction_assembly(s, y, g, w, u, h_diag, count)
    errs = {}
    for c in SCALE64_CHECK:
        sl = slice(c, c + 1)
        s64, y64, g64 = s[sl].double(), y[sl].double(), g[sl].double()
        ref = cc.fused_gram_projections_plain(s64, y64, g64, count[sl])
        errs[f"gram[{c}]"] = max(rel_err(a[sl].double(), b) for a, b in zip(gram, ref))
        ref_asm = cc.fused_direction_assembly_plain(s64, y64, g64, w[sl].double(), u[sl].double(),
                                                    h_diag[sl].double(), count[sl])
        errs[f"assembly[{c}]"] = rel_err(asm[sl].double(), ref_asm)
        del s64, y64, g64
    finite = all(bool(torch.isfinite(t).all()) for t in (*gram, asm))
    print(f"scale64 kernels K={k} N={n} vs_f64 " + " ".join(f"{nm}={v:.3e}" for nm, v in errs.items())
          + f" finite={finite}", flush=True)
    if not finite or not max(errs.values()) <= RTOL:
        fail(f"compact kernel disagrees with float64 at K={k} N={n}: {errs} (finite={finite})")

    s.nan_to_num_(0.0)
    y.nan_to_num_(0.0)
    x[:, :M], x[:, M : 2 * M] = s, y
    full = torch.full((k,), M, dtype=torch.int32, device="cuda")
    coef = torch.cat([w, -h_diag[:, None] * u, h_diag[:, None]], dim=1)[:, None, :]
    iters = 5 if n > 1_000_000 else 50
    calls = {
        "fused_gram_projections": (lambda: cc.fused_gram_projections(s, y, g, full),
                                   lambda: torch.matmul(x, x.transpose(1, 2)), (2 * M + 1) * n * 4 * k),
        "fused_direction_assembly": (lambda: cc.fused_direction_assembly(s, y, g, w, u, h_diag, full),
                                     lambda: torch.matmul(coef, x), (2 * M + 2) * n * 4 * k),
    }
    chunks, per_block = cc.gram_chunks(n)
    rows = {}
    for name, (kernel, library, n_bytes) in calls.items():
        ms, device_ms = time_ms(kernel, iters)
        _, library_device_ms = time_ms(library, iters)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {"device_ms": device_ms, "ms": ms, "bound_ms": bound_ms, "library_device_ms": library_device_ms}
        print(f"timing {name} K={k} N={n} m={M} ms={ms:.6f} device_ms={device_ms:.6f} bound_ms={bound_ms:.6f} "
              f"(bytes) share_of_bound={bound_ms / device_ms:.3f} library_device_ms={library_device_ms:.6f}"
              + (f" grid={chunks}x{k} tiles_per_block={per_block}" if name == "fused_gram_projections" else ""),
              flush=True)
    del x, s, y, g
    return rows


def phase_scale64_train(metrics_out, profile: bool):
    """The scale64 presets (K=64 ResNet18 clients on CIFAR-100) at full
    width on one card: fedavg_scale64 over one round of block7 (N =
    4,720,640 a client, the largest group: a `[64, 10, N]` history of 12.08
    GB for s and for y, updated in place), nadmm 1, then admm_scale64 over
    one round of the linear head (N = 51,300), nadmm 3, both with the
    fused-kernel direction, on 8,192 synthetic train images (a `reduced`
    line); then both compact kernels at K=64 at both N."""
    from federated_pytorch_test_tpu_torch.data import synthetic_cifar

    print(f"reduced scale64: {SCALE64_TRAIN} train images of CIFAR-100's 50,000 (synthetic stand-in, "
          f"{SCALE64_TRAIN // SCALE64_K // 32} minibatches of 32 a client), one round of one group a preset, "
          f"nloop 1 of 12", flush=True)
    source = synthetic_cifar(SCALE64_TRAIN, SCALE64_TEST, num_classes=100, seed=0)
    launches, walls, peaks = {}, {}, {}
    for preset, gid, nadmm in (("fedavg_scale64", 8, 1), ("admm_scale64", 9, 3)):
        rec, launches[preset], walls[preset], peaks[preset] = scale64_run(preset, gid, nadmm, source)
    if metrics_out:
        rec.save(metrics_out)
    del source, rec
    times = {n: scale64_kernels(n) for n in SCALE64_SIZES}
    return launches, sum(walls.values()), walls, peaks, times


def fan_run(cfg, source, label: str, group_order=None):
    """One Trainer run with launches counted; returns (trainer, rec,
    launches of every kernel family, wall)."""
    import torch

    from federated_pytorch_test_tpu_torch.engine import Trainer
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    tr = Trainer(cfg, verbose=False, source=source)
    if group_order is not None:
        tr.group_order = group_order
    cc.reset_launch_counts()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**cc.LAUNCHES, **fc.LAUNCHES}
    reads = sum(r["value"]["host_reads"] for r in rec.series["objective_passes"])
    passes = Counter()
    for r in rec.series["objective_passes"]:
        passes.update({k: v for k, v in r["value"].items() if k != "host_reads"})
    n_steps = len(rec.series["train_loss"])
    print(f"fan {label} wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"host_reads={reads} host_reads_per_minibatch={reads / n_steps:.3f} passes={json.dumps(dict(passes))}",
          flush=True)
    check_finite_run(f"fan {label}", rec)
    return tr, rec, launches, wall


class record_searches:
    """Within the block, every Armijo search `lbfgs_step` runs is recorded:
    `self.calls` gets, per call, the rungs evaluated (step sizes and losses,
    `[K, R]` each, in the order evaluated) and the accepted step sizes `[K]`."""

    def __enter__(self):
        import torch

        from federated_pytorch_test_tpu_torch.optim import lbfgs

        self.calls, self.module = [], lbfgs
        self.saved = lbfgs.backtracking_armijo_aux, lbfgs.backtracking_armijo_probes_aux
        sequential, fan = self.saved

        def record(search, widen):
            def recorded(evaluate, *args, **kw):
                seen = []

                def evaluated(alpha):
                    out = evaluate(alpha)
                    seen.append((widen(alpha), widen(out[0])))
                    return out

                out = search(evaluated, *args, **kw)
                self.calls.append((torch.cat([a for a, _ in seen], 1), torch.cat([f for _, f in seen], 1), out[0]))
                return out

            return recorded

        lbfgs.backtracking_armijo_aux = record(sequential, lambda t: t[:, None])
        lbfgs.backtracking_armijo_probes_aux = record(fan, lambda t: t)
        return self

    def __exit__(self, *exc):
        self.module.backtracking_armijo_aux, self.module.backtracking_armijo_probes_aux = self.saved


def search_ties(seq_calls, fan_calls) -> list:
    """The searches of two steps from one state, call by call, up to and
    including the first call whose accepted step differs for a client
    (the calls after it start elsewhere): for each such client, the rung
    where the decisions part (the larger accepted step: one search took
    it, the other rejected it) and the two evaluations' losses there. Returns [(call, client, step size, sequential
    loss, fan loss)]."""
    out, parted = [], set()
    for i, ((a1, f1, acc1), (a4, f4, acc4)) in enumerate(zip(seq_calls, fan_calls)):
        for k in range(acc1.shape[0]):
            if k in parted or bool(acc1[k] == acc4[k]):
                continue
            parted.add(k)
            alpha = max(float(acc1[k]), float(acc4[k]))
            pick = lambda a, f: float(f[k][a[k] == alpha][0])
            out.append((i, k, alpha, pick(a1, f1), pick(a4, f4)))
    return out


def fan_vs_sequential(source) -> dict:
    """The fedavg preset's loop (Net, K=3, batch 512, phase 7's inputs) step
    by step: the sequential search (P=1) makes
    the trajectory, and before each step the fan at `FAN_PROBES` under
    'gemm' and 'vmap' gets the same parameters and optimizer state. Every
    accepted step size of every search is compared; where a client's
    parts from the sequential one, the two evaluations of the parting rung
    (the larger of the two accepted step sizes: one search accepted it, the
    other did not) must agree within float32's resolution of a
    cross-entropy, `FAN_TIE_ATOL` or relative `FAN_TIE_RTOL`: the rung sat
    on the Armijo threshold. Returns the counts per fold."""
    import dataclasses

    import torch

    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.engine.steps import (client_train_step, epoch_batches, fedavg_consensus,
                                                               round_init)
    from federated_pytorch_test_tpu_torch.optim import clone_state

    tr = Trainer(get_preset("fedavg", nloop=1, lbfgs_direction="pallas"), verbose=False, source=source)
    counts = {fold: Counter() for fold in ("gemm", "vmap")}
    worst = {fold: 0.0 for fold in counts}
    for gid in tr.group_order:
        ctx = tr.ctx(gid)
        fans = {fold: dataclasses.replace(ctx, lbfgs=dataclasses.replace(ctx.lbfgs, ls_probes=FAN_PROBES),
                                          client_fold=fold) for fold in counts}
        state, cstate = round_init(ctx, tr.flat)
        for a in range(tr.cfg.nadmm):
            idx = tr.epoch_indices(0, gid, a, 0)
            for imgs, labels in epoch_batches(tr.shard_imgs, tr.shard_labels, idx):
                args = (imgs, labels, tr.mean, tr.std)
                with record_searches() as seq:
                    flat, state_next, _, _ = client_train_step(ctx, tr.flat.clone(), clone_state(state), {}, *args)
                for fold, c in fans.items():
                    with record_searches() as fan:
                        flat4, st4, _, _ = client_train_step(c, tr.flat.clone(), clone_state(state), {}, *args)
                    cnt = counts[fold]
                    cnt["searches"] += len(seq.calls)
                    cnt["steps"] += 1
                    cnt["equal_params_steps"] += bool(torch.equal(flat4, flat))
                    for call, k, alpha, f1, f4 in search_ties(seq.calls, fan.calls):
                        cnt["parted"] += 1
                        diff = abs(f1 - f4)
                        worst[fold] = max(worst[fold], diff)
                        tie = diff <= max(FAN_TIE_ATOL, FAN_TIE_RTOL * abs(f1))
                        cnt["ties" if tie else "not_ties"] += 1
                        print(f"fan parted fold={fold} group={gid} step={cnt['steps'] - 1} search={call} client={k} "
                              f"rung_step={alpha:.6e} loss_sequential={f1:.9e} loss_fan={f4:.9e} tie={tie}",
                              flush=True)
                tr.flat, state = flat, state_next
            tr.flat, cstate, _ = fedavg_consensus(ctx, tr.flat, cstate)
    for fold, cnt in counts.items():
        print(f"fan steps from one state fold={fold} steps={cnt['steps']} searches={cnt['searches']} "
              f"steps_with_equal_params={cnt['equal_params_steps']} parted={cnt['parted']} ties={cnt['ties']} "
              f"not_ties={cnt['not_ties']} max_parting_loss_diff={worst[fold]:.3e}", flush=True)
        if cnt["not_ties"]:
            fail(f"fan fold={fold}: {cnt['not_ties']} searches parted from the sequential one at a rung whose two "
                 "losses differ by more than float32's resolution")
    return counts


def phase_probe_fan_train(metrics_out, profile: bool, reference=None):
    """The line search's probe fan on the card: the fedavg preset (Net, K=3,
    batch 512, phase 7's inputs) with the fused-kernel direction at
    `linesearch_probes=1`, then at 4 under both folds, 'gemm' and 'vmap':
    compact launches gated exactly, walls and host reads printed. The run
    at 1 against `reference` (phase 7's loss series): bitwise over the
    whole loop, since the port's defaults make a run repeat bit for bit
    (deterministic cuDNN). Then the same loop step by step
    from one state (`fan_vs_sequential`): the fan's accepted steps equal the
    sequential search's up to rungs on the Armijo threshold. Then one ViT
    round (block1, patch 2, flash attention) at 4 with the rectangular
    flash and compact launches gated."""
    import numpy as np

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc

    source = synthetic_cifar(50_000, 10_000, seed=0)
    runs, walls, launches = {}, {}, {}
    for p, fold in ((1, "gemm"), (FAN_PROBES, "gemm"), (FAN_PROBES, "vmap")):
        label = f"net P={p} fold={fold}"
        cfg = get_preset("fedavg", nloop=1, lbfgs_direction="pallas", linesearch_probes=p, client_fold=fold)
        tr, rec, launch, walls[label] = fan_run(cfg, source, label)
        runs[label] = rec
        launches[label] = launch
        gate_launches(f"fan {label}", launch, {name: expected_launches(rec)["direction"] for name in cc.LAUNCHES})
    base_rec = runs["net P=1 fold=gemm"]
    if metrics_out:
        base_rec.save(metrics_out)
    if reference is not None:
        losses = [r["value"] for r in base_rec.series["train_loss"]]
        same = losses == reference
        diff = max(abs(a - b) for x, y in zip(losses, reference) for a, b in zip(x, y))
        print(f"fan net P=1 train_loss bitwise_equal_to_phase_7 ({len(losses)} minibatches)={same} "
              f"max_abs_diff={diff:.3e}", flush=True)
        if not same:
            fail("fan: the linesearch_probes=1 run's loss series differs from phase 7's")
    fan_vs_sequential(source)

    label = f"vit P={FAN_PROBES} fold=gemm block1"
    cfg = get_preset("fedavg", model="vit", model_kwargs=VIT_KWARGS, nloop=1, nadmm=1, lbfgs_direction="pallas",
                     linesearch_probes=FAN_PROBES)
    vit_source = synthetic_cifar(VIT_TRAIN, VIT_TEST, seed=0)
    tr, rec, launch, walls[label] = fan_run(cfg, vit_source, label, group_order=[2])
    launches[label] = launch
    exp = expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs))  # an evaluation: one pass a test batch
    gate_launches(f"fan {label}", launch, {
        **{name: exp["direction"] for name in cc.LAUNCHES},
        "flash_fwd_rect": exp["forward"], "flash_bwd_dq_rect": exp["backward"], "flash_bwd_dkv_rect": exp["backward"]})
    final_acc = np.asarray(rec.series["test_accuracy"][-1]["value"])
    print(f"fan {label} accuracy {final_acc.round(4).tolist()}", flush=True)
    return launches, sum(walls.values()), walls


# One turn of `--ab-parent`, run in a fresh process from the root of a
# checkout, its arguments JSON lists of train phases and of assembly sizes
# (AB_ASSEMBLY_SIZES) and a directory (or ""): the device ms of the
# grouped GEMM at every MoE ViT path shape on f32 and on bf16 operands, of
# the gram at every Net group size, of the assembly at every one of those
# sizes (full history), of the bf16 trio at BF16_PATHS (with its autograd
# forward and backward, and SDPA's forward, backward and both on the same
# bf16 inputs), of the f32 forward,
# dq and dk/dv at both precisions at the LM's and the ViT's shapes
# (FLASH_PATH, RECT_PATH, LM128_PATH, VIT128_PATH; the backward from the
# plain forward's lse and delta) and of SDPA's f32 backward at the two D-128
# shapes, as one JSON line; the digests of the bf16 grouped GEMM's outputs,
# of the assembly's (with `history`'s counts: a NaN-filled invalid row), of
# the bf16 trio's, of the f32 forward's o and lse, of the f32 dq's and
# dk/dv's and of each train phase's loss series, as one JSON line; then the
# walls of those train phases of that checkout (the LM's group-0 epoch
# profiled; a phase with walls by label, `phase_vit_d128`, one a label) as
# one JSON line. Given a directory, the bf16 grouped GEMM's outputs are
# saved there (`ab_units` compares the two checkouts').
AB_TURN = """
import hashlib, json, os, sys, tempfile
phases, asm_sizes, save_dir = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
sys.path.insert(0, ".")
import chip_smoke as cs
from federated_pytorch_test_tpu_torch.utils import configure_precision
configure_precision()
import torch
from federated_pytorch_test_tpu_torch.engine import get_preset
from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
from federated_pytorch_test_tpu_torch.optim.compact import compact_solves, history_valid
def digest(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]
times, digests = {}, {}
for i, (label, role, shapes) in enumerate(cs.grouped_cases(get_preset("fedavg", model="vit",
                                                                      model_kwargs=cs.VIT_MOE_KWARGS))):
    gen = torch.Generator(device="cuda").manual_seed(100 + i)
    a, b = (torch.randn(*sh, device="cuda", generator=gen) for sh in shapes)
    kernel = cs.grouped_role(role)[0]
    times[label] = cs.time_ms(lambda: kernel(a, b), 20)[1]
    del a, b
for i, (label, role, shapes) in enumerate(cs.grouped_cases(get_preset("fedavg", model="vit",
                                                                      model_kwargs=cs.VIT_MOE_KWARGS))):
    gen = torch.Generator(device="cuda").manual_seed(300 + i)  # phase 12's inputs
    a, b = (torch.randn(*sh, device="cuda", generator=gen).to(torch.bfloat16) for sh in shapes)
    kernel = cs.grouped_role(role)[0]
    out = kernel(a, b)
    digests[f"grouped bf16 {label}"] = digest(out.view(torch.int16))
    if save_dir:
        torch.save(out.cpu(), os.path.join(save_dir, f"grouped bf16 {label}.pt"))
    times[f"grouped bf16 {label}"] = cs.time_ms(lambda: kernel(a, b), 20)[1]
    del a, b, out
full = torch.full((cs.K,), cs.M, dtype=torch.int32, device="cuda")
for n in cs.NET_GROUP_SIZES:
    s, y, g, count, _ = cs.history(n, seed=n)
    s.nan_to_num_(0.0)
    y.nan_to_num_(0.0)
    times[f"gram N={n}"] = cs.time_ms(lambda: cc.fused_gram_projections(s, y, g, full), 200)[1]
    del s, y, g
for n in asm_sizes:
    s, y, g, count, h_diag = cs.history(n, seed=n)
    sy, yy, p, q = cc.fused_gram_projections_plain(s, y, g, count)
    u, w, _, _ = compact_solves(sy, p, q, history_valid(count, cs.M), h_diag,
                                lambda uu: (torch.matmul(yy, uu[..., None])[..., 0], None))
    digests[f"assembly N={n}"] = digest(cc.fused_direction_assembly(s, y, g, w, u, h_diag, count))
    s.nan_to_num_(0.0)
    y.nan_to_num_(0.0)
    times[f"assembly N={n}"] = cs.time_ms(lambda: cc.fused_direction_assembly(s, y, g, w, u, h_diag, full),
                                          20 if n > 200_000 else 200)[1]
    del s, y, g
import torch.nn.functional as F
from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc
for bh, s_len, d in cs.BF16_PATHS:  # the bf16 trio, and its autograd forward and backward beside SDPA's
    (q, k, v, do), (q16, k16, v16) = cs.bf16_inputs(bh, s_len, d, seed=41)
    scale = 1.0 / d ** 0.5
    qs = fc.prescale_q(q16, scale)
    o, lse = fc.flash_fwd_bf16(qs, k16, v16)
    delta, do16 = (do * o).sum(-1), do.to(torch.bfloat16)
    tag = f"BH={bh} S={s_len} D={d}"
    times[f"flash_fwd_bf16 {tag}"] = cs.time_ms(lambda: fc.flash_fwd_bf16(qs, k16, v16), 20)[1]
    digests[f"flash_fwd_bf16 {tag}"] = digest(torch.cat([o.flatten(), lse.flatten()]))
    digests[f"flash_bwd_dkv_bf16 {tag}"] = digest(
        torch.cat([t.flatten() for t in fc.flash_bwd_dkv_bf16(qs, k16, v16, do16, lse, delta)]).view(torch.int16))
    times[f"flash_bwd_dq_bf16 {tag}"] = cs.time_ms(
        lambda: fc.flash_bwd_dq_bf16(qs, k16, v16, do16, lse, delta, scale), 20)[1]
    digests[f"flash_bwd_dq_bf16 {tag}"] = digest(
        fc.flash_bwd_dq_bf16(qs, k16, v16, do16, lse, delta, scale).view(torch.int16))
    times[f"flash_bwd_dkv_bf16 {tag}"] = cs.time_ms(lambda: fc.flash_bwd_dkv_bf16(qs, k16, v16, do16, lse, delta), 20)[1]
    q3, k3, v3 = (t.detach().requires_grad_(True) for t in (q16, k16, v16))
    times[f"fwd+bwd bf16 {tag}"] = cs.time_ms(
        lambda: torch.autograd.grad(fc._FlashCausalBf16.apply(q3, k3, v3, scale), (q3, k3, v3), do), 20)[1]
    q4, k4, v4 = (t.detach().view(1, bh, s_len, d).requires_grad_(True) for t in (q16, k16, v16))
    times[f"sdpa fwd+bwd bf16 {tag}"] = cs.time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), (q4, k4, v4), do16.view(1, bh, s_len, d)), 20)[1]
    times[f"sdpa fwd bf16 {tag}"] = cs.time_ms(lambda: F.scaled_dot_product_attention(
        q4.detach(), k4.detach(), v4.detach(), is_causal=True), 20)[1]
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    times[f"sdpa bwd bf16 {tag}"] = cs.time_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), do16.view(1, bh, s_len, d), retain_graph=True), 20)[1]
    del q, k, v, do, q16, k16, v16, qs, o, lse, delta, do16, q3, k3, v3, q4, k4, v4, o4
for aligned, (bh, s_len, d) in ((True, cs.FLASH_PATH), (False, cs.RECT_PATH), (True, cs.LM128_PATH),
                                 (False, cs.VIT128_PATH)):  # the f32 forward at the LM's and the ViT's shapes
    q, k, v, _ = cs.flash_inputs(bh, s_len, d, seed=43)
    scale = 1.0 / d ** 0.5
    for precision in fc.PRECISIONS:
        if aligned:
            fwd = lambda: fc.flash_fwd(q, k, v, scale, precision)
        else:
            fwd = lambda: fc.flash_fwd_rect(q, k, v, scale, precision=precision)
        name = ("flash_fwd" if aligned else "flash_fwd_rect") + ("" if precision == "highest" else "_1pass")
        tag = f"{name} BH={bh} S={s_len} D={d}"
        digests[tag] = digest(torch.cat([t.flatten() for t in fwd()]))
        times[tag] = cs.time_ms(fwd, 20)[1]
    del q, k, v
for aligned, (bh, s_len, d) in ((True, cs.FLASH_PATH), (False, cs.RECT_PATH), (True, cs.LM128_PATH),
                                 (False, cs.VIT128_PATH)):  # the f32 dq and dk/dv at the same shapes
    q, k, v, do = cs.flash_inputs(bh, s_len, d, seed=43)
    scale = 1.0 / d ** 0.5
    o, lse = fc.flash_fwd_plain(q, k, v, scale) if aligned else fc.flash_fwd_rect_plain(q, k, v, scale)
    delta = (do * o).sum(-1)
    del o
    for precision in fc.PRECISIONS:
        if aligned:
            calls = {"flash_bwd_dq": lambda: (fc.flash_bwd_dq(q, k, v, do, lse, delta, scale, precision),),
                     "flash_bwd_dkv": lambda: fc.flash_bwd_dkv(q, k, v, do, lse, delta, scale, precision)}
        else:
            calls = {"flash_bwd_dq_rect": lambda: (fc.flash_bwd_dq_rect(q, k, v, do, lse, delta, scale,
                                                                        precision=precision),),
                     "flash_bwd_dkv_rect": lambda: fc.flash_bwd_dkv_rect(q, k, v, do, lse, delta, scale,
                                                                         precision=precision)}
        for name, fn in calls.items():
            tag = f"{name}{'' if precision == 'highest' else '_1pass'} BH={bh} S={s_len} D={d}"
            digests[tag] = digest(torch.cat([t.flatten() for t in fn()]))
            times[tag] = cs.time_ms(fn, 20)[1]
    if d == 128:  # the yardstick: SDPA's whole f32 backward, [1, BH, S, D]
        q4, k4, v4 = (t.detach().view(1, bh, s_len, d).requires_grad_(True) for t in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=aligned)
        times[f"sdpa bwd f32 BH={bh} S={s_len} D={d}"] = cs.time_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do.view(1, bh, s_len, d), retain_graph=True), 20)[1]
        del q4, k4, v4, o4
    del q, k, v, do, lse, delta
print("ab kernels " + json.dumps(times), flush=True)
walls = {}
with tempfile.TemporaryDirectory() as d:
    for p in phases:
        if not hasattr(cs, p):
            continue
        out = os.path.join(d, p + ".json")
        if p == "phase_vit_bf16_train":  # (metrics_out): its remat run beside
            wall = cs.phase_vit_bf16_train(out)[1]
        elif p == "phase_vit_moe_bf16_train":  # (metrics_out, f32_wall, f32_peak): no f32 run to print beside
            wall = cs.phase_vit_moe_bf16_train(out, 0.0, 0.0)[1]
        else:
            wall = getattr(cs, p)(out, p == "phase_lm_train")[1]
        walls.update({f"{p} {k}": w for k, w in wall.items()} if isinstance(wall, dict) else {p: wall})
        series = json.load(open(out))["series"] if os.path.exists(out) else {}
        if "train_loss" in series:
            losses = [r["value"] for r in series["train_loss"]]
            digests[p + " train_loss"] = hashlib.sha256(json.dumps(losses).encode()).hexdigest()[:16]
print("ab digests " + json.dumps(digests), flush=True)
print("ab walls " + json.dumps(walls), flush=True)
"""
AB_RUNS = 3  # turns of each checkout
AB_PHASES = "phase_train,phase_lm_train,phase_vit_train,phase_vit_moe_train"  # `--ab-phases` default
AB_CHOICES = ("phase_train", "phase_lm_train", "phase_vit_train", "phase_vit_moe_train", "phase_admm_train",
              "phase_no_consensus_train", "phase_scale64_train",
              "phase_probe_fan_train", "phase_lm_d128",
              "phase_vit_d128",  # the phases whose `phase(metrics_out, profile)[1]` is a wall (or walls by label)
              "phase_vit_bf16_train", "phase_vit_moe_bf16_train")  # and the bf16 ViT paths, called as they stand
# the assembly's sizes in an A/B: Net's groups, Net1's whole vector and the
# aligned N beside it, the ResNet18 groups (admm_resnet's, largest first)
# and `LARGE_N`
AB_ASSEMBLY_SIZES = (*NET_GROUP_SIZES, NO_CONSENSUS_N, ALIGNED_NO_CONSENSUS_N, 4_720_640, 3_673_088, 1_180_672,
                     919_040, 295_424, 230_144, 73_984, 5_130, 1_856, LARGE_N)
AB_BUILD = ("import sys; sys.path.insert(0, '.'); import chip_smoke as cs; "
            "from federated_pytorch_test_tpu_torch.ops import build; [build.build(n) for n in cs.SOURCES]")


def run_ab(parent: str, runs: int, phases) -> None:
    """The kernel times (the grouped GEMM on f32 and bf16 operands, gram,
    assembly, the bf16 flash trio with its autograd forward and backward
    beside SDPA's forward, backward and both at `BF16_PATHS`, the f32 flash forward, dq and dk/dv at the
    LM's and the ViT's shapes at both precisions, SDPA's f32 backward at the
    D-128 ones) and the walls of the train `phases` of
    another checkout (`parent`, e.g. `git archive` of the parent commit
    unpacked) and of this one, `runs` turns each, in fresh processes taking
    turns parent, change, change, parent, ... after both have built their
    kernels. Every line of a turn is printed with its checkout's tag; then
    each kernel's device ms per turn and the median ratio (change over
    parent), each wall's pair differences (change minus parent) and their
    median, and for each digest (a bf16 grouped GEMM output, an assembly
    output, the bf16 trio's outputs, the f32 forward's, dq's and dk/dv's, a
    phase's loss series) whether every
    turn of both checkouts gave the same bits; for each bf16 grouped GEMM
    shape, how far the change's output lies from the parent's (`ab_units`)."""
    import statistics
    import tempfile

    trees = {"parent": os.path.abspath(parent), "change": HERE}
    with ThreadPoolExecutor(2) as pool:  # both builds at once, outside the timed turns
        for tag, proc in zip(trees, pool.map(lambda t: subprocess.run(
                [sys.executable, "-c", AB_BUILD], cwd=t, capture_output=True, text=True), trees.values())):
            if proc.returncode != 0:
                fail(f"ab: the {tag} checkout did not build:\n{proc.stdout}{proc.stderr}")
    order = [("parent", "change"), ("change", "parent")]
    walls = {"parent": [], "change": []}
    kernel_ms = {"parent": [], "change": []}
    digests = {"parent": [], "change": []}
    args = [json.dumps(list(phases)), json.dumps(AB_ASSEMBLY_SIZES)]
    saved = tempfile.TemporaryDirectory()  # each checkout's first turn's bf16 grouped outputs
    for tag in trees:
        os.makedirs(os.path.join(saved.name, tag))
    for turn in range(runs):
        for tag in order[turn % 2]:
            save = os.path.join(saved.name, tag) if turn == 0 else ""
            proc = subprocess.run([sys.executable, "-c", AB_TURN, *args, save], cwd=trees[tag], capture_output=True,
                                  text=True)
            for line in (proc.stdout + proc.stderr).splitlines():
                print(f"[{tag} {turn}] {line}", flush=True)
            if proc.returncode != 0:
                fail(f"ab: the {tag} checkout's turn {turn} failed (exit {proc.returncode})")
            walls[tag].append(json.loads(proc.stdout.split("ab walls ")[-1].splitlines()[0]))
            kernel_ms[tag].append(json.loads(proc.stdout.split("ab kernels ")[-1].splitlines()[0]))
            digests[tag].append(json.loads(proc.stdout.split("ab digests ")[-1].splitlines()[0]))
    for name in kernel_ms["change"][0]:
        par, chg = ([t[name] for t in kernel_ms[tag]] for tag in ("parent", "change"))
        print(f"ab device_ms {name} parent={[round(x, 6) for x in par]} change={[round(x, 6) for x in chg]} "
              f"median_ratio={statistics.median(c / p for c, p in zip(chg, par)):.4f}", flush=True)
    for phase in walls["change"][0].keys() & walls["parent"][0].keys():
        diffs = [c[phase] - p[phase] for c, p in zip(walls["change"], walls["parent"])]
        print(f"ab {phase} parent={[round(p[phase], 3) for p in walls['parent']]} "
              f"change={[round(c[phase], 3) for c in walls['change']]} "
              f"diffs={[round(x, 3) for x in diffs]} median_diff={statistics.median(diffs):.3f}", flush=True)
    for key in digests["change"][0]:
        par, chg = ([t.get(key) for t in digests[tag]] for tag in ("parent", "change"))
        print(f"ab bitwise {key} parent_turns_equal={len(set(par)) == 1} change_turns_equal={len(set(chg)) == 1} "
              f"parent_equals_change={set(par) == set(chg) and len(set(par)) == 1} "
              f"parent={par[0]} change={chg[0]}", flush=True)
    ab_units(os.path.join(saved.name, "parent"), os.path.join(saved.name, "change"))
    saved.cleanup()


def ab_units(parent_dir: str, change_dir: str) -> None:
    """For each output saved in both directories (the bf16 grouped GEMM at a
    MoE ViT shape, from each checkout's first turn): how many elements
    differ and the largest distance in bf16 units of the largest entry
    (`bf16_units`)."""
    import torch

    for name in sorted(set(os.listdir(parent_dir)) & set(os.listdir(change_dir))):
        par, chg = (torch.load(os.path.join(d, name)).cuda() for d in (parent_dir, change_dir))
        differ = int((par.view(torch.int16) != chg.view(torch.int16)).sum())
        print(f"ab units {name[:-3]} elements={par.numel()} differing={differ} "
              f"change_vs_parent_bf16_units={bf16_units(chg, par):.3f}", flush=True)
        del par, chg


def main() -> int:
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--metrics-out", help="write the main path's metric series as JSON here")
    ap.add_argument("--lm-metrics-out", help="write the LM path's metric series as JSON here")
    ap.add_argument("--vit-metrics-out", help="write the ViT path's metric series as JSON here")
    ap.add_argument("--vit-moe-metrics-out", help="write the MoE ViT path's metric series as JSON here")
    ap.add_argument("--admm-metrics-out", help="write the admm path's metric series as JSON here")
    ap.add_argument("--resnet-metrics-out", help="write the admm_resnet path's metric series as JSON here")
    ap.add_argument("--no-consensus-metrics-out", help="write the no_consensus path's metric series as JSON here")
    ap.add_argument("--net-bf16-metrics-out", help="write the bf16 fedavg (Net) path's metric series as JSON here")
    ap.add_argument("--vit-bf16-metrics-out", help="write the bf16 ViT path's metric series as JSON here")
    ap.add_argument("--vit-moe-bf16-metrics-out", help="write the bf16 MoE ViT path's metric series as JSON here")
    ap.add_argument("--scale64-metrics-out", help="write the admm_scale64 run's metric series as JSON here")
    ap.add_argument("--fan-metrics-out", help="write the probe fan phase's P=1 run's metric series as JSON here")
    ap.add_argument("--lm-d128-metrics-out", help="write the head-dim-128 LM round's metric series as JSON here")
    ap.add_argument("--vit-d128-metrics-out", help="write the head-dim-128 ViT round's (f32) metric series as JSON here")
    ap.add_argument("--profile", action="store_true", help="also profile one epoch of each path")
    ap.add_argument("--ab-parent", metavar="DIR",
                    help="instead of the phases, time the train paths of the checkout in DIR and of this "
                         "one in turns (see run_ab)")
    ap.add_argument("--ab-phases", default=AB_PHASES,
                    help="the train phases an --ab-parent turn runs, comma-separated, of " + ", ".join(AB_CHOICES)
                         + " (default: %(default)s)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    try:
        import federated_pytorch_test_tpu_torch  # noqa: F401
        from federated_pytorch_test_tpu_torch.ops import build
        from federated_pytorch_test_tpu_torch.utils import configure_precision
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    configure_precision()
    t_all = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    if args.ab_parent:
        run_ab(args.ab_parent, AB_RUNS, [p for p in args.ab_phases.split(",") if p])
        return 0

    def timed_build(name):
        t0 = time.perf_counter()
        return build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, all at once
        built = list(pool.map(timed_build, SOURCES))
    for lib, seconds in built:
        print(f"build {lib.name} seconds={seconds:.3f}", flush=True)
    report_tensor_core_build(built[SOURCES.index("flash_attention")][0], "flash_attention", flash_label)
    report_tensor_core_build(built[SOURCES.index("flash_bf16")][0], "flash_bf16", flash_label)
    report_tensor_core_build(built[SOURCES.index("grouped_gemm")][0], "grouped_gemm", grouped_label)
    report_tensor_core_build(built[SOURCES.index("grouped_gemm_bf16")][0], "grouped_gemm_bf16", grouped_bf16_label)

    report = timed(phase_kernels)
    flash_report = timed(phase_flash)
    rect_report = timed(phase_flash_rect)
    default_report = timed(phase_flash_default)
    bf16_report, bf16_launches = timed(phase_flash_bf16)
    timed(phase_parity)
    launches, wall, train_rec = timed(phase_train, args.metrics_out, args.profile)
    net16_launches, net16_wall = timed(phase_net_bf16_train, args.net_bf16_metrics_out)
    timed(phase_lm_parity)
    lm_launches, lm_wall = timed(phase_lm_train, args.lm_metrics_out, args.profile)
    lm16_launches, lm16_wall, lm16_extra = timed(phase_lm_default)
    lm128_launches, lm128_wall, lm128_extra = timed(phase_lm_d128, args.lm_d128_metrics_out, args.profile)
    timed(phase_auto_crossover)
    timed(phase_vit_parity)
    vit_launches, vit_wall = timed(phase_vit_train, args.vit_metrics_out, args.profile)
    vit16_launches, vit16_wall, vit16_extra = timed(phase_vit_bf16_train, args.vit_bf16_metrics_out)
    vit128_launches, vit128_walls, vit128_peaks = timed(phase_vit_d128, args.vit_d128_metrics_out, args.profile)
    grouped_report = timed(phase_grouped)
    grouped_bf16_report = timed(phase_grouped_bf16)
    timed(phase_vit_moe_parity)
    moe_launches, moe_wall, moe_peak = timed(phase_vit_moe_train, args.vit_moe_metrics_out, args.profile)
    moe16_launches, moe16_wall, moe16_peak = timed(phase_vit_moe_bf16_train, args.vit_moe_bf16_metrics_out,
                                                   moe_wall, moe_peak)
    admm_launches, admm_wall = timed(phase_admm_train, args.admm_metrics_out, args.profile)
    timed(phase_resnet_parity)
    resnet_launches, resnet_walls, resnet_times = timed(phase_resnet_train, args.resnet_metrics_out, args.profile)
    nc_launches, nc_wall = timed(phase_no_consensus_train, args.no_consensus_metrics_out, args.profile)
    nc_rows = timed(phase_compact_no_consensus)
    timed(phase_resume)
    repeat_walls = timed(phase_repeat)
    s64_launches, _, s64_walls, s64_peaks, s64_times = timed(phase_scale64_train, args.scale64_metrics_out,
                                                             args.profile)
    fan_launches, _, fan_walls = timed(phase_probe_fan_train, args.fan_metrics_out, args.profile,
                                       reference=[r["value"] for r in train_rec.series["train_loss"]])

    kernels = []
    replaces = {
        "fused_gram_projections": "federated_pytorch_test_tpu/ops/compact_pallas.py:115",
        "fused_direction_assembly": "federated_pytorch_test_tpu/ops/compact_pallas.py:171",
    }
    for name in ("fused_gram_projections", "fused_direction_assembly"):
        r = report[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/compact_direction.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            # `ms`, `plain_ms` and `library_ms` are per call with the host's
            # launch path; the `device_*` times are the card's alone
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": f"K={K} m={M} N={REPORT_N}",
            # each compact path's launches, counted over its run; `launches`
            # above is the fedavg (Net) path's
            "launches_by_path": {"fedavg": launches[name], "fedavg_bf16": net16_launches[name],
                                 "vit_bf16": vit16_launches[name], "admm": admm_launches[name],
                                 **{p: n[name] for p, n in resnet_launches.items()},
                                 "vit": vit_launches[name], "vit_moe": moe_launches[name],
                                 "vit_moe_bf16": moe16_launches[name],
                                 "no_consensus": nc_launches[name],
                                 **{p: n[name] for p, n in s64_launches.items()},
                                 **{f"fan {p}": n[name] for p, n in fan_launches.items()}},
            # device ms at K=64 (the scale64 paths) at block7 and at the
            # 100-class head, beside the bytes bound and the `matmul` yardstick
            "scale64_sizes": {str(n): r[name] for n, r in s64_times.items()},
            # device ms at every ResNet group size the ResNet paths reach, beside
            # the bound, the plain version and the `matmul` yardstick
            "resnet_sizes": {str(n): r[name] for n, r in resnet_times.items()},
            # the same at the no_consensus path's one group (Net1's whole
            # vector), with the plain two_loop direction and the kernel
            # direction (both kernels and the small solves) beside them
            # and at 890,408, the nearest N with 16-byte aligned rows
            "no_consensus_sizes": {str(n): {
                k: r[name][k] for k in ("device_ms", "bound_ms", "library_device_ms", "plain_device_ms",
                                        "two_loop_device_ms", "direction_device_ms") if k in r[name]}
                for n, r in nc_rows.items()},
        })
    bh, s, d = FLASH_PATH
    for name, r in flash_report.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": lm_launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # bound_ms: split TF32 on the tensor cores, the exps or the bytes,
            # whichever is largest (bound_term); the f32 FFMA design's ceiling beside it
            "bound_term": r["bound_term"],
            "ffma_bound_ms": r["ffma_bound_ms"],
            # scaled_dot_product_attention: its forward for flash_fwd; its
            # backward (dq, dk and dv in one call) for the two backward kernels
            "library_ms": r["library_ms"],
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": f"BH={bh} S={s} D={d} causal",
            # device times at each path shape (the LM's at D 16 and at D 128); the D-128 LM round's launches
            "shapes": r["shapes"],
            "launches_by_path": {"lm": lm_launches[name], "lm d128": lm128_launches[name]},
        })
    bh, s, d = RECT_PATH
    for name, r in rect_report.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/flash_attention.cu",
            "replaces": RECT_REPLACES[name],
            "launches": vit_launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # bound_ms: split TF32 on the tensor cores, the exps or the bytes,
            # whichever is largest (bound_term); the f32 FFMA design's ceiling beside it
            "bound_term": r["bound_term"],
            "ffma_bound_ms": r["ffma_bound_ms"],
            # scaled_dot_product_attention without a mask: its forward for
            # flash_fwd_rect; its backward for the two backward kernels
            "library_ms": r["library_ms"],
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": f"BH={bh} S={s} D={d} non-causal",
            # device times at each path shape (the ViT's at D 16 and at D 128); the D-128 ViT round's launches
            "shapes": r["shapes"],
            "launches_by_path": {"vit": vit_launches[name], "vit d128": vit128_launches["vit d128 f32"][name]},
        })
    from federated_pytorch_test_tpu_torch.ops.flash_cuda import ONE_PASS

    one_pass_launches = {**{ONE_PASS[n]: lm16_launches[ONE_PASS[n]] for n in FLASH_REPLACES},
                         **{ONE_PASS[n]: vit16_launches[ONE_PASS[n]] for n in RECT_REPLACES}}
    one_pass_d128 = {**{ONE_PASS[n]: lm128_extra["model_launches"][ONE_PASS[n]] for n in FLASH_REPLACES},
                     **{ONE_PASS[n]: vit128_launches["vit d128 bf16"][ONE_PASS[n]] for n in RECT_REPLACES}}
    for name, r in default_report.items():
        base = name[: -len("_1pass")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/flash_attention.cu",
            "replaces": {**FLASH_REPLACES, **RECT_REPLACES}[base],
            # the LM model phase (causal) and the bf16 ViT path (rectangular) at 'default'
            "launches": one_pass_launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # bound_ms: one TF32 product at 495 TFLOP/s, the exps or the bytes (bound_term)
            "bound_term": r["bound_term"],
            # scaled_dot_product_attention on the same f32 inputs
            "library_ms": r["library_ms"],
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": r["shape"],
            "shapes": r["shapes"],
            # the D-128 LM model at bf16/'default' (causal) and the D-128 ViT round at bf16 (rectangular)
            "launches_d128": one_pass_d128[name],
        })
    for name, r in bf16_report.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/flash_bf16.cu",
            "replaces": BF16_REPLACES[name],
            # the public op on bf16 inputs at 'default', forward and backward, at both shapes
            "launches": bf16_launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # bound_ms: bf16 products at 989 TFLOP/s, the exps or the bytes (bound_term)
            "bound_term": r["bound_term"],
            # scaled_dot_product_attention on the same bf16 inputs
            "library_ms": r["library_ms"],
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": r["shape"],
            "shapes": r["shapes"],
        })
    for name, r in grouped_report.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/grouped_gemm.cu",
            "replaces": GROUPED_REPLACES,
            "launches": moe_launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # bound_ms: split TF32 on the tensor cores or the bytes, whichever is
            # larger (bound_term); an f32 FFMA design's ceiling beside it
            "bound_term": r["bound_term"],
            "ffma_bound_ms": r["ffma_bound_ms"],
            # torch.bmm on the same operand views, TF32 off (for the sum: torch.sum over the splits)
            "library_ms": r["library_ms"],
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": r["shape"],
            "splits": r["splits"],
            "l2": r.get("l2", "as left by the previous call"),
        })
    for name, r in grouped_bf16_report.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/grouped_gemm_bf16.cu",
            "replaces": GROUPED_REPLACES,
            # the bf16 MoE ViT path (phase 14″)
            "launches": moe16_launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # bound_ms: bf16 products at 989 TFLOP/s or the bytes (bf16 operands
            # and output; f32 partials and a bf16 sum for the split sum)
            "bound_term": r["bound_term"],
            # torch.bmm on the same bf16 operand views (for the sum: torch.sum, cast to bf16)
            "library_ms": r["library_ms"],
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": r["shape"],
            "splits": r["splits"],
            "l2": r.get("l2", "as left by the previous call"),
        })
    print(f"total seconds={time.perf_counter() - t_all:.3f} train_wall_s={wall:.3f} lm_train_wall_s={lm_wall:.3f} "
          f"vit_train_wall_s={vit_wall:.3f} vit_moe_train_wall_s={moe_wall:.3f} vit_moe_peak_gb={moe_peak:.3f} "
          f"vit_moe_bf16_train_wall_s={moe16_wall:.3f} vit_moe_bf16_peak_gb={moe16_peak:.3f} "
          f"admm_train_wall_s={admm_wall:.3f} "
          f"admm_resnet_train_wall_s={resnet_walls['admm_resnet']:.3f} "
          f"fedavg_resnet_train_wall_s={resnet_walls['fedavg_resnet']:.3f} "
          f"no_consensus_train_wall_s={nc_wall:.3f} net_bf16_train_wall_s={net16_wall:.3f} "
          f"vit_bf16_train_wall_s={vit16_wall:.3f} vit_bf16_remat_train_wall_s={vit16_extra['remat_wall_s']:.3f} "
          f"lm_model_bf16_default_fwd_bwd_s={lm16_wall:.3f} lm_model_f32_fwd_bwd_s={lm16_extra['f32_wall_s']:.3f} "
          f"lm_d128_round_wall_s={lm128_wall:.3f} lm_d128_peak_gb={lm128_extra['peak_gb']:.3f} "
          + " ".join(f"{p.replace(' ', '_')}_round_wall_s={w:.3f} {p.replace(' ', '_')}_peak_gb={vit128_peaks[p]:.3f}"
                     for p, w in vit128_walls.items()) + " "
          + " ".join(f"padded_{k.replace(' ', '_')}_fwd_bwd_device_ms={v['device_ms']:.6f}_vs_d128_{v['d128_device_ms']:.6f}"
                     for k, v in PADDED.items()) + " "
          + " ".join(f"{p}_train_wall_s={w:.3f} {p}_peak_gb={s64_peaks[p] / 1e9:.3f}" for p, w in s64_walls.items())
          + " " + " ".join(f"fan_{p.replace(' ', '_')}_wall_s={w:.3f}" for p, w in fan_walls.items())
          + " " + " ".join(f"repeat_{p}_round_wall_s={w:.3f}" for p, w in repeat_walls.items()),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
