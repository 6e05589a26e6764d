#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, server, timings.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` first, one ``nvcc`` per source, all
started together) and ``nvidia-smi``.  It imports nothing of the JAX
package.  Phases:

1. Each CUDA kernel against its plain PyTorch version on the card, at the
   shapes of the G7 ``soc_pokec`` stand-in at full size (fp32 and bf16
   streams), and on an ``OPTIMIZED_CONFIG`` plan (raw window 2, hot-row
   spill) at scale 0.1.  Elementwise tolerance:
   ``|y_kernel - y_plain| <= 1e-5 * (|A| @ |x|) + 1e-6`` — the kernels sum
   with fp32 atomics in another order than the plain ``index_add_``.  The
   SpMV stream pass's and the SpMM kernel's ``-Xptxas=-v`` lines are
   printed (a spill fails the run).  The stream pass runs on both G7
   streams and the ``OPTIMIZED_CONFIG`` plan as ``spmv_plan`` plans it,
   and on the fp32 G7 stream on a plan forced to two row windows of 8
   lanes; the plan that ran is read back (``spmv_last_plan``), here and
   wherever a stream pass or fused step is timed.  Each SpMM
   vector width runs on both streams and on the ``OPTIMIZED_CONFIG``
   plan: v4 at N = 16 (four row-window passes at G7) or 64 (two at scale
   0.1), v2 at N = 2, v1 at N = 3 and, at G7, at N = 16 on an X one
   element into its storage.  The width that ran is read from
   ``spmm_launches_by_width``.  Each check, SpMV's and SpMM's, has a
   control, the same stream with its first live tile emptied, that must
   fail it.
2. The server answers requests: ``MatrixRegistry(device="cuda")`` holds
   the G7 stand-in, and ``SpMVService`` serves 48 requests from 3 owners
   with mixed alpha/beta, first synchronously and then pipelined, each run
   checked against an fp64 host reference under the same tolerance.  The
   kernels' launch counters are set to 0 just before each run and read
   just after; each kernel must have launched, and the served batches
   must have run the v4 SpMM body (the launches by width are printed).
   Both runs are traced (``repro_torch.obs``) and print the host seconds
   spent in each span.
3. Timings with CUDA events at the G7 shapes: kernel, plain version, and
   one ``torch.sparse`` CSR product as a yardstick (the port never calls
   it), beside the bound the card's memory rate sets.  spmv (fp32 and
   bf16 streams) and ``torch.mv`` on CSR are read in turns (one order,
   then the reverse), each line with the plan.  SpMM is timed at
   each served width N = 2, 4, 8, 16, in turns with ``torch.mm`` on CSR
   (kernel, CSR, CSR, kernel), each line with its bound, its row-window
   passes, the bound with the stream counted once per pass, and the card.
4. The solvers (the second slice's path), through ``SpMVService.solve``:
   PageRank on the column-normalised G7 stand-in at full size
   (``tol=1e-6``: the fp32 L1 delta's noise floor is near n·ulp(1/n) ≈
   1e-7 at this n, so 1e-7 would stall), held against an fp64 scipy
   PageRank of the same iteration count within ``1e-5·max(r) + 1e-9``
   elementwise; CG (``tol=1e-6``, true fp64 residual ≤ 1e-4) and 100
   power iterations (λ against the fp64 Rayleigh quotient of the returned
   v, rel 1e-4) on the G5 stand-in made SPD (upper triangle mirrored,
   diagonal = row's Σ|off-diagonal| + 1).  The fused kernel's launch
   counter is set to 0 before these solves and read after; each solve
   must be fused.  Then each solve again with ``fused=False`` (the spmv
   kernel plus torch ops): iteration counts within 1, solutions within
   the tolerances printed.  One fused step per epilogue against
   ``spmv_fused_plain`` on the same card tensors (acc as in phase 1;
   state vectors within 1e-5 of their magnitude; reduced scalars within
   ``1e-5·Σ|terms| + 1e-6``), and CUDA-event timings of the fused step
   and of ``torch.mv`` on a CSR tensor plus the epilogue in torch ops (a
   yardstick only), in turns, of one iteration of each solver's own fused
   and unfused loop bodies (16 iterations a run) and of the plain
   version.  If the run has passed 8 minutes before the G5 part, G5 runs
   at scale 0.25 and says so; the G7 PageRank never shrinks.
5. LM serving (the third slice's path) through the flash-attention
   kernel, whose bf16 served heads run its Hopper body (``wgmma``: TMA
   K/V ring, wgmma, a producer warpgroup up to 128 columns);
   ``flash_body`` picks the body from dtype, head dims and alignment, and
   the per-body counters show which ran.  The wgmma body's
   ``-Xptxas=-v`` lines are printed (a spill, or wgmma that ptxas
   serialised, fails the run).  (a) The kernel against its plain version
   on card tensors at qwen1.5-0.5b heads (B = 4, S = 2000, bf16 and fp32),
   chatglm3-6b heads (KV = 2, G = 16, dh = 128, S = 4096, bf16), one
   non-causal case, one with dv ≠ dh in fp32 and minicpm3-4b's MLA heads
   (B = 4, S = 2000, 40 heads, dh = 96, dv = 64, bf16); each bf16 case
   runs the wgmma body on its tensors and, on a copy one element into its
   storage, the mma body; elementwise ``|Δ| <= tol·(1 + |plain|)`` with
   tol 2e-5 in fp32 (the reference kernel tests') and 2e-2 in bf16, and
   in bf16 also ``||Δ|| <= 5e-3·||plain||``, which a kernel that drops
   one kv tile fails (checked at qwen's and at MLA's heads, for both
   bodies).  (b) ``ServeEngine`` serves 4 prompts of 2000 tokens plus 16
   greedy decode steps on qwen1.5-0.5b at full width and depth in bf16,
   random weights from a seeded generator; the flash counters are set to
   0 before ``generate`` and must read one wgmma launch per layer after
   it.  The same prefill with ``flash_attention_plain`` swapped in for the
   kernel gives last-position logits and a last-layer attention output
   within the ``LM_BF16_*`` bounds; in fp32, 4 decode steps give the
   logits and the last-layer attention output of a prefill of the longer
   prompt within the ``LM_FP32_*`` bounds.  Each of these bounds is held
   against a control that must fail it (non-causal attention, one layer's
   attention zeroed, a decode one position off).  (c) CUDA-event times of
   the wgmma body, the mma body (on an offset copy of the same tensors)
   and ``scaled_dot_product_attention`` (a yardstick the port never
   calls), in turns, and of the plain version, at the served shape and at
   the ``prefill_32k`` length (B = 1, S = 32768).
6. Auto-tuned serving (the tenth slice's path): a ``MatrixRegistry``
   with a seeded ``PlanTuner`` takes ``put(spec="auto")`` of the
   full-size G7 stand-in and prints its features, bucket, ranked arms,
   choice and tune/encode seconds.  Every arm of the bucket is built from
   one prepared sort (``plan_from_prepared``), bound, held against the
   phase-2 fp64 references on 4 requests under the same tolerance beside
   a control with its first live tile emptied that must fail, and timed
   with CUDA events in turns (spmv on one vector, SpMM at N = 16 on a
   card-resident X, through the operator), each line with the stream
   pass's plan and the card; each reading goes to ``tuner.observe``, and
   ``registry.retune`` must leave the entry on the arm with the most
   requests/s.  The tuner's JSON is printed (not committed).  Then
   ``SpMVService(retune_every=4)`` serves phase 2's mix pipelined against
   the auto-tuned entry (counts set to 0 before, read after; spmv and
   spmm must have launched), held against fp64, and the tuner's
   decision, re-tune and predicted/observed metrics are printed.  If the
   run has passed 8 minutes before phase 6, the arms are measured on the
   G7 stand-in at scale 0.25, which must fall in the same bucket.
7. The eleventh slice's modules.  (a) Every full-size put of the run
   (G7 in the setup and phase 6, G7 column-normalised and G5 in phase 4)
   goes through the registry's ``verify="fast"`` gate: its ``verify``
   span's seconds are printed and its findings must be 0, and a copy of
   the installed plan with one corruption (a nonzero padding value, or
   two tiles' seg ids swapped) must be refused with
   ``VerificationError`` naming its rule.  Full mode runs at scale 0.1
   (about 1.4 us a slot on the host; a minute at G7's 33.5 M slots), on
   phase 1's ``OPTIMIZED_CONFIG`` plan and a bf16 put of the G7 stand-in,
   each beside a copy with one live slot's column bit flipped, which only
   full mode's round-trip proof sees.  (b) ``cost_report(measure=True)``
   of the full-size G7 operator: stream bytes, padding, lane imbalance,
   measured ms (median of 20, CUDA events), GB/s and ``roofline_fraction``
   at 3350 GB/s; the measured time must be at least the modeled one and
   within 1.5x of phase 6's operator-level spmv of ``single:1:modulo``.
   (c) Phase 2's 48 requests in one sync flush inside ``profiler_trace``
   (counts set to 0 before, read after): the trace must hold SpMM kernel
   events (their count is printed beside the launches: the profiler can
   drop records) and device time in ``key_averages()``; the card's busy
   share of the flush is printed.  (d) ``SparseLinear`` at
   qwen1.5-0.5b's FFN widths, all 24 layers (72 operators, seeded random
   weights pruned by ``from_dense(density=0.15)``): one decode step's FFN
   at batch 1 (spmv) and batch 4 (SpMM, N = 4), counts set to 0 before
   and read after, each projection held against the fp32 dense product
   of its pruned weight under ``|Δ| <= 1e-5·(|W|·|x|) + 1e-6`` beside a
   control with one kept weight zeroed, which must fail; one projection
   of each shape timed in turns against ``torch.mv``/``torch.mm`` on CSR
   and on the dense pruned weight (yardsticks the port never calls).

8. llama4-scout MoE serving (the thirteenth slice's path), after every
   earlier phase's streams, registries and models are released (the free
   card memory is printed).  (a) The flash kernel at the served prefill's
   shape, (B, S, KV, G, dh) = (4, 2000, 8, 5, 128) in bf16, causal: the
   wgmma body and the mma body (offset copy) against the plain version
   under phase 5(a)'s tolerances, then timed in turns with
   ``scaled_dot_product_attention`` on the same tensors, beside its bound
   (the unmasked pairs' flops at 989 TFLOP/s, 0.166 ms).  (b)
   ``ServeEngine`` serves 4 prompts of 2000 tokens plus 16 greedy decode
   steps on llama4-scout-17b-a16e at its published width (d 5120, 40 q
   heads over 8 KV of 128, 16 experts of d_ff 8192, top-1, vocab
   202,048) and 12 of its 48 layers (48 take 203.5 GB), bf16, random
   weights from a seeded generator made on the card; the flash counters
   are set to 0 before ``generate`` and must read one wgmma launch per
   layer after it.  Prefill ms, decode ms a step, peak memory, a
   ``torch.profiler`` breakdown, layer 0's tokens per expert, the host
   syncs of one MoE layer (``torch.cuda`` sync debug mode) and its share
   of the step are printed.  (c) The same prefill with
   ``flash_attention_plain`` swapped in: last-position logits within
   ``LM_BF16_LOGIT_TOL``, and equal greedy first tokens wherever the
   plain logits' top two lie more than twice the measured |Δ| apart (the
   only place the bound can move the argmax).  (d) Layer 0's MoE on 64
   of its prefill inputs, card bf16 against the same function on the CPU
   in fp32 with the same weights: equal routing and
   ``||Δ|| <= MOE_LAYER_REL·||cpu||``, beside a control with two experts
   that received tokens swapped, which must fail.
9. mamba2-1.3b SSM serving (the fourteenth slice's path), after phase
   8's model is released (the free card memory is printed).  (a)
   ``ServeEngine`` serves 4 prompts of 2000 tokens plus 16 greedy decode
   steps on mamba2-1.3b at its published width and depth (48 SSD
   layers, d 2048, 64 heads of 64, d_state 128, chunk 256, vocab 50,280,
   tied), bf16, random weights from a seeded generator made on the card;
   the kernels' counters are set to 0 before ``generate`` and must all
   read 0 after it (the model has no attention).  Prefill ms, decode ms a
   step, the decode state's shapes and a ``torch.profiler`` breakdown
   (busy share, kernel launches, top kernels) are printed; the serve's
   peak allocation above what it started with must stay within
   ``SSM_PEAK_OVER``, and a prefill whose conv tails are views of the
   whole projections (the control) must exceed it.  (d) One mamba layer
   alone on layer 0's served input: ms (CUDA events) at prefill and
   decode size, its share (×48) of the served prefill and
   step, and its host syncs (sync debug mode), which must be none.  (b)
   In fp32 (a copy of the served weights), the decode of token 257 after
   a 256-token prefill against the last position of a 257-token prefill
   (across the chunk boundary): logits within ``SSM_HANDOFF_TOL``, first
   tokens equal outside the 2d band, and the same decode from a zeroed
   ``h`` must fail; the bf16 weights' |Δ| is printed as a reading.  (c)
   Layer 0's mixer on 4 × 300 of its served inputs, on the card in bf16
   and in fp32 against the CPU in fp32 from the same bf16 weights:
   ``||Δ|| <= SSM_LAYER_REL·||cpu||`` in bf16 (a control with conv_x's
   taps reversed must fail) and ``SSM_LAYER_FP32_REL`` in fp32 (the scan
   without its inter-chunk carry must fail).

10. minicpm3-4b MLA serving (the fifteenth slice's path), after phase
   9's model is released (the free card memory is printed).  The flash
   kernel at the served prefill's shape (q (4, 2000, 40, 1, 96), v (...,
   64), bf16, causal): the wgmma body, the mma body (on an offset copy)
   and ``scaled_dot_product_attention`` at the same head dims timed in
   turns, beside the plain version and its bound (the unmasked pairs'
   flops at 989 TFLOP/s, 0.104 ms).  (a) ``ServeEngine`` serves 4
   prompts of 2000 tokens plus 16 greedy decode steps on minicpm3-4b at
   its published width and depth, nothing cut (62 layers, d 2560, 40
   heads, q_lora 768, kv_lora 256, rope 32 + nope 64, v 64, d_ff 6400,
   vocab 73,448, untied), bf16, random weights from a seeded generator
   made on the card; the kernels' counters are set to 0 before
   ``generate`` and must read one wgmma launch per layer and no other
   body.  Prefill ms, decode ms a step, the latent cache's bytes beside
   a full K/V cache's, peak memory and a ``torch.profiler`` breakdown
   are printed.  (d) One MLA layer alone on layer 0's served input: ms
   (CUDA events) at prefill and decode size, its share (×62) of the
   served prefill and step, and its host syncs, which must be none.  (b)
   Layer 0's MLA mixer on 4 × 320 of its served inputs, the card in bf16
   against the CPU in fp32 from the same weights: ``||Δ|| <=
   MLA_LAYER_REL·||cpu||``, which the query heads split as ``[nope,
   rope]`` and the expansion without ``kv_norm`` must fail.  (c) In fp32
   (a copy of the served weights), the decode of token 301 after a
   300-token prefill against the last position of a 301-token prefill:
   logits within ``MLA_HANDOFF_TOL``, first tokens equal outside the 2d
   band, and the same decode with the cache's ``krope`` zeroed must
   fail; the bf16 weights' |Δ| and control are printed as readings.

11. whisper-base encoder-decoder serving (the seventeenth slice's path),
   after phase 10's model is released (the free card memory is printed).
   The flash kernel at the served prefill's two non-causal shapes in
   bf16, the encoder's (16, 1500, 1500, 8, 1, 64, 64) and the
   cross-attention's (16, 192, 1500, ...): the wgmma body and the mma
   body (offset copy) against the plain version under phase 5(a)'s
   tolerances, beside a control with one 64-key tile dropped for the
   last 64 queries that must fail, then timed in turns with
   ``scaled_dot_product_attention``, beside the plain version and the
   bound (the encoder's flops at 989 TFLOP/s, 0.0745 ms; the cross
   shape's bytes at 3.35 TB/s, 0.0166 ms).  ``ServeEngine`` serves 16
   clips of 1500 stub frames, each with a 192-token prompt, plus 64
   greedy tokens on whisper-base at its published width and depth,
   nothing cut (6 encoder and 6 decoder layers, d 512, 8 heads of 64,
   d_ff 2048 gelu, vocab 51,865 padded to 51,968, untied), bf16, random
   weights from a seeded generator made on the card; the kernels'
   counters are set to 0 before ``generate`` and must read 18 wgmma
   launches (each encoder layer, each decoder layer's self and cross)
   and no other body.  The encoder's ms (CUDA events), prefill ms,
   decode ms a step, the cross cache's bytes beside the self K/V's, peak
   memory and a ``torch.profiler`` breakdown are printed.  (b) Encoder
   layer 0's self-attention and decoder layer 0's cross-attention on 2
   clips of their served inputs, the card in bf16 against the CPU in
   fp32 from the same weights: ``||Δ|| <= WHISPER_LAYER_REL·||cpu||``,
   which each run causal must fail.  (c) In fp32 (a copy of the served
   weights), the decode of token 193 after a 192-token prefill against
   the last position of a 193-token prefill over the same frames: logits
   within ``WHISPER_HANDOFF_TOL``, first tokens equal outside the 2d
   band, and the same decode with the cache's ``xk`` zeroed must fail.
12. The VLM slice (paligemma-3b: the vision prefix and its prefix-LM
   mask).  The mma and fma bodies' ``-Xptxas=-v`` lines at 64, 128 and
   256 columns and the wgmma body's at (256, 256), with its shared
   memory, are printed (a spill fails the run).
   (a) The flash kernel with a prefix against its plain version: the
   served shape (8, 320, 320, 1 KV, G 8, 256, 256) with ``prefix_len``
   256 in bf16, and a ragged prefix of 200 at (64, 64), (128, 128) and
   (256, 256), each on the wgmma body and on the mma body (an offset
   copy), and on the fp32 fma body at 256, under phase 5(a)'s
   tolerances; each beside the same call with ``prefix_len=0``, which
   must fail them.  The wgmma body and the mma body (offset copy) are
   timed at the served shape in turns with
   ``scaled_dot_product_attention`` under the same boolean prefix-LM
   mask (the backend its dispatcher picks, named) and causal without
   the prefix, beside the plain version and the bound (its bytes at
   3.35 TB/s, 0.0070 ms).  ``ServeEngine`` serves 8
   images of 256 stub patches, each with a 64-token prompt, plus 32
   greedy tokens on paligemma-3b at its published width and depth,
   nothing cut (18 layers, d 2048, 8 query heads of 256 over 1 KV head,
   d_ff 16384 gated gelu, vocab 257,216 padded to 257,280, untied),
   bf16, random weights from a seeded generator made on the card; the
   kernels' counters are set to 0 before ``generate`` and must read 18
   wgmma launches and no other body.  Prefill ms, decode ms a step, peak
   memory and a ``torch.profiler`` breakdown are printed.  (b) Layer 0's
   attention on 2 images of the served batch's embedded prefix, the card
   in bf16 against the CPU in fp32 from the same weights: ``||Δ|| <=
   PALI_LAYER_REL·||cpu||``, which the same layer run with
   ``prefix_len=0`` must fail.  (c) In fp32 (a copy of the served
   weights, all 18 layers), the decode of text token 65 after a
   256 + 64-position prefill against the last position of the 256 +
   65-position prefill of the same images: logits within
   ``PALI_HANDOFF_TOL``, and the same decode after a prefill whose
   ``vis_proj`` is zeroed must fail.
13. Training qwen1.5-0.5b (the twentieth slice: ``LM.loss``, the
   flash-attention backward kernel in the autograd Function
   ``FlashAttention``, AdamW, checkpoint/restart, the launcher), after
   phase 12's model is released.  The backward's ``-Xptxas=-v`` lines
   (bf16 builds at 64, 128 and 256 columns; a spill fails the run) are
   printed.  (a) ``flash_attention_bwd`` against its
   plain version on card tensors at the training shape (8, 2048, 16 KV,
   G 1, 64, 64) causal, llama4's GQA (8 KV, G 5, 128), minicpm3's MLA
   pair (96, 64), whisper's non-causal cross shape (Sq 192, Sk 1500),
   paligemma's heads of 256 with ``prefix_len`` 256, and one fp32 shape:
   dq, dk and dv each within ``BWD_REL`` of plain in norm, beside a
   control that must fail (the diagonal shifted by one, the prefix
   ignored, or the non-causal call run causal).  (b) At the training
   shape, queued behind a spin kernel and in turns: the kernel and the
   backward of ``scaled_dot_product_attention`` through autograd (a
   yardstick the port never calls; its backend named), beside the plain
   version and the bound (2.5x the forward's unmasked-pair flops at 989
   TFLOP/s, or its bytes at 3.35 TB/s).  (c) ``repro_torch.launch.train``
   trains qwen1.5-0.5b at its published width and depth (24 layers, d
   1024, 16 heads of 64, vocab 151,936, tied, bf16 weights, fp32 AdamW
   moments, remat), 4 steps of 8 x 2048 tokens from the synthetic
   pipeline; the counters are set to 0 before and read after: the losses
   must be finite and fall, each step must launch the backward kernel 24
   times and the forward's wgmma body 48 (remat runs each period's
   forward twice).  ms a step, tokens/s and the peak allocation beside
   the state's bytes are printed, then a ``torch.profiler`` breakdown of
   one more step.  The trained weights' bf16 loss and layer 0's wq
   gradient on one (1, 256) batch are held against the CPU's fp32 run of
   the same weights (``TRAIN_LOSS_REL``, ``TRAIN_GRAD_REL``), and the
   backward with its mask off (the control) must fail.  (d)
   Checkpoint/restart at the full width and 2 layers: 4 steps
   uninterrupted against 2 steps, a checkpoint under ``build/``, a fresh
   ``Trainer`` that restores it and 2 more: losses within
   ``TRAIN_RESTART_TOL``.

Phase 7's flush trace goes to ``build/traces/`` (git-ignored).
Any failed check raises, and the script then exits nonzero without its
last line.  The last line is ``{"ok": true, "device": {...}}``; the line
before it is the kernels' JSON record (the backward's entry from phase
13: its launches in (c), its times and bound at the training shape and
SDPA-backward's time as its library time), whose flash entry also lists each
body's main-path launches and its times, bounds and library times at
the seven timed shapes (``bodies``: phase 5's served prefill and
prefill_32k, llama4's served prefill, minicpm3's, whisper's encoder and
cross shapes and paligemma's prefix-LM prefill, these four with their
plain time), whose spmm entry
lists each vector width's main-path launches (``bodies``) and, at each
served width, its
time, CSR's, the bound and the passes (``by_n``), and whose spmv and
spmv_fused entries give the stream pass's plan at G7 (``plan``: lanes a
block, row windows, tile splits).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.analysis.verify import VerificationError  # noqa: E402
from repro_torch.core import format as sformat  # noqa: E402
from repro_torch.core import partition as cpart  # noqa: E402
from repro_torch.core.autotune import (PlanTuner,  # noqa: E402
                                       TunerCandidate)
from repro_torch.core.features import features_of  # noqa: E402
from repro_torch.core.registry import (MatrixRegistry,  # noqa: E402
                                       verify_gate)
from repro_torch.core.sparse_linear import (SparseLinear,  # noqa: E402
                                            magnitude_prune)
from repro_torch.core.spmv import SerpensOperator  # noqa: E402
from repro_torch.data.matrices import (column_normalize,  # noqa: E402
                                       paper_matrix)
from repro_torch.solvers.cg import (  # noqa: E402
    _cg_epilogue, _solve_fused, _solve_unfused)
from repro_torch.solvers.power_iteration import (  # noqa: E402
    _pagerank_epilogue, _pagerank_fused, _pagerank_unfused, _power_epilogue,
    _power_fused, _power_unfused)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import serpens_spmv as ks  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import LM, _cross_kv  # noqa: E402
from repro_torch.obs.profile import profiler_trace  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.spmv_service import SpMVService  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TOL_REL, TOL_ABS = 1e-5, 1e-6
SEED = 0
N_REQUESTS = 48
OWNERS = ("alice", "bob", "carol")

KERNELS = {
    "spmv": {"route": "cuda",
             "source": "src/repro_torch/kernels/csrc/serpens_spmv.cu",
             "replaces": "src/repro/kernels/serpens_spmv.py:68"},
    "spmm": {"route": "cuda",
             "source": "src/repro_torch/kernels/csrc/serpens_spmv.cu",
             "replaces": "src/repro/kernels/serpens_spmv.py:147"},
    "spmv_fused": {"route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/serpens_spmv.cu",
                   "replaces": "src/repro/kernels/serpens_spmv.py:192"},
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:80"},
    # No Pallas backward: the reference trains through jax autodiff of its
    # plain chunked_attention.
    "flash_attention_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:70"},
}
# nvcc's output per kernel source (the -Xptxas=-v report), by stem.
BUILD_LOGS: dict[str, str] = {}
# The G5 part of phase 4 shrinks to this scale once the run has passed
# SLOW_RUN_S seconds (the script must end well inside 1200 s).
SLOW_RUN_S = 480.0
G5_SMALL_SCALE = 0.25


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_close(what: str, got, want, scale, atol: float = TOL_ABS
                ) -> float:
    """Elementwise ``|got - want| <= TOL_REL * scale + atol``; returns
    the largest absolute error."""
    got = torch.as_tensor(got)
    want = torch.as_tensor(want, device=got.device, dtype=got.dtype)
    scale = torch.as_tensor(scale, device=got.device, dtype=got.dtype)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > TOL_REL * scale + atol
    if bool(bad.any()):
        i = int(torch.argmax((err - TOL_REL * scale).flatten()))
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements out of tolerance; worst "
            f"flat index {i}: |err| {float(err.flatten()[i])} vs scale "
            f"{float(scale.flatten()[i])}")
    return float(err.max())


def time_ms(fn, iters: int) -> float:
    """Mean ms per call on the card (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int) -> float:
    """Mean ms per call on the card at the card's pace: a spin kernel
    holds the stream while the host queues all ``iters`` calls, so a
    wrapper whose host cost nears its kernel's time (tens of µs) is not
    timed at the host's pace (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Twice the host's queueing time at up to 2 GHz, plus 1 ms.
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def stream_on_card(plan, dev):
    """The single-shard plan's stream as card tensors, plus its geometry."""
    if plan.num_shards != 1:
        raise AssertionError("phase 1 expects a single-shard plan")
    idx, val, seg = ops.device_arrays(plan.shards[0], dev)
    geo = dict(num_rows_padded=plan.out_rows_padded,
               segment_width=plan.config.segment_width)
    return idx, val, seg, geo


def compare_spmv(what, idx, val, seg, x, geo, tpc: int,
                 plan=None) -> tuple[float, str]:
    """One stream pass against the plain version on the same inputs (as
    :func:`ks.spmv` plans it, or on a forced ``plan``), and the same
    stream with its first live tile emptied, which must fail the same
    check.  The plan that ran is read back.  Returns the error and the
    line to print."""
    rows = geo["num_rows_padded"]

    def run(i_):
        if plan is None:
            return ks.spmv(i_, val, seg, x, tiles_per_chunk=tpc, **geo)
        return ks._spmv_run(i_, val, seg, x, plan, **geo)

    want_plan = plan or ks._card_spmv_plan(idx, rows)
    got = run(idx)
    torch.cuda.synchronize()
    if ks.spmv_last_plan != want_plan:
        raise AssertionError(f"{what}: ran {ks.spmv_last_plan}, not "
                             f"{want_plan}")
    want = ks.spmv_plain(idx, val, seg, x, **geo)
    scale = ks.spmv_plain(idx, val.abs(), seg, x.abs(), **geo)
    err = check_close(f"{what} spmv kernel vs plain", got, want, scale)
    first = int(torch.nonzero((idx != -1).flatten(1).any(1))[0])
    cut = idx.clone()
    cut[first] = -1
    ctl = run(cut)
    torch.cuda.synchronize()
    try:
        check_close(f"{what} control", ctl, want, scale)
    except AssertionError as fail:
        msg = str(fail)
    else:
        raise AssertionError(f"{what}: the control without tile {first} "
                             f"passes the check")
    del cut, ctl, want, scale
    p = want_plan
    return err, (f"{what}: plan {p.lane_group} lanes a block, "
                 f"{len(p.windows)} window(s), {p.splits} split(s), "
                 f"{p.blocks} blocks, {p.smem_bytes} B shared; spmv err "
                 f"{err:.3e}; control without tile {first} fails as it "
                 f"must ({msg.split(': ', 1)[1].split(';')[0]})")


def ptxas_report(stem: str, pattern: str, label, want) -> str:
    """The ``-Xptxas=-v`` lines (registers, spills) of every entry function
    in ``stem``'s build whose name matches ``pattern``, each as
    ``label(match): ...``; raises on a spill, on wgmma that ptxas
    serialised ("Potential Performance Loss"), or unless the labels are
    ``want`` (each once)."""
    log = BUILD_LOGS.get(stem, "")
    if not log:
        return "no nvcc log (the library was already built)"
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        hit = re.search(pattern, line)
        if hit is not None and "Performance Loss" in line:
            raise AssertionError(f"{stem} {label(hit)}: {line.strip()}")
        if hit is None or "Compiling entry function" not in line:
            continue
        name = label(hit)
        props = " ".join(x.split(":", 1)[-1].strip() if "ptxas" in x
                         else x.strip() for x in lines[i + 2:i + 4])
        if any(int(n) for n in re.findall(r"(\d+) bytes spill", props)):
            raise AssertionError(f"{stem} {name} spills: {props}")
        out.append((name, props))
    if sorted(n for n, _ in out) != sorted(want):
        raise AssertionError(f"no ptxas report for every {stem} build in "
                             f"{sorted(want)}: {out}")
    return "; ".join(f"{n}: {x}" for n, x in out)


def value_type(hit) -> str:
    return "fp32" if hit[1] == "f" else "bf16"


def ran_plan(fn, seen: set):
    """``fn``, adding to ``seen`` the stream-pass plan each call ran."""
    def run():
        out = fn()
        seen.add(ks.spmv_last_plan)
        return out
    return run


def one_plan(what: str, seen: set, want):
    """``want``, once every call recorded in ``seen`` ran it; raises if any
    call ran another plan."""
    if seen != {want}:
        raise AssertionError(f"{what} ran {seen}, not {want}")
    return want


def plan_record(plan) -> dict:
    return {"lane_group": plan.lane_group, "windows": len(plan.windows),
            "splits": plan.splits}


def in_turns(fns: dict, iters: int, timer=time_ms) -> dict:
    """CUDA-event ms of each function (``timer``), read in turns: in the
    dict's order, then in reverse.  Means, and the readings under
    ``reads``."""
    reads = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            reads[name].append(timer(fns[name], iters))
    return {name: float(np.mean(r)) for name, r in reads.items()} | {
        "reads": reads}


def host_reference(rows, cols, vals, m, x, alpha, beta, y):
    """fp64 ``alpha * A @ x + beta * y`` and its tolerance scale."""
    xv = x.astype(np.float64)[cols]
    ax = np.bincount(rows, weights=vals * xv, minlength=m)
    absax = np.bincount(rows, weights=np.abs(vals) * np.abs(xv),
                        minlength=m)
    ref = alpha * ax
    scale = abs(alpha) * absax
    if y is not None:
        ref = ref + beta * y.astype(np.float64)
        scale = scale + abs(beta) * np.abs(y.astype(np.float64))
    return ref, scale


def make_requests(rng, m: int, k: int):
    """48 (x, alpha, beta, y, owner) requests: some with beta = 0, no y."""
    reqs = []
    for i in range(N_REQUESTS):
        x = rng.standard_normal(k).astype(np.float32)
        alpha = float(rng.uniform(-2.0, 2.0))
        if i % 3 == 0:
            beta, y = 0.0, None
        else:
            beta = float(rng.uniform(-1.0, 1.0))
            y = rng.standard_normal(m).astype(np.float32)
        reqs.append((x, alpha, beta, y, OWNERS[i % len(OWNERS)]))
    return reqs


def serve_sync(svc, mid, reqs):
    """Lone request first (matvec path), then the other 47 in one flush
    (two full 16-wide batches and one of 15 padded to 16)."""
    x, a, b, y, o = reqs[0]
    t0 = svc.submit(mid, x, alpha=a, beta=b, y=y, owner=o)
    out = svc.flush()
    tickets = [svc.submit(mid, x, alpha=a, beta=b, y=y, owner=o)
               for x, a, b, y, o in reqs[1:]]
    out.update(svc.flush())
    res = [out[t] for t in [t0] + tickets]
    shapes = [(r.batch_size, r.bucket_n) for r in res]
    want = [(1, 1)] + [(16, 16)] * 32 + [(15, 16)] * 15
    if shapes != want:
        raise AssertionError(f"sync batches {shapes} != {want}")
    return res


def serve_pipelined(svc, mid, reqs):
    """The same mix through the running pipeline: the lone request is
    collected before the rest are submitted, so it runs alone."""
    with svc:
        x, a, b, y, o = reqs[0]
        first = svc.result(svc.submit(mid, x, alpha=a, beta=b, y=y,
                                      owner=o), timeout=300)
        tickets = [svc.submit(mid, x, alpha=a, beta=b, y=y, owner=o)
                   for x, a, b, y, o in reqs[1:]]
        res = [first] + [svc.result(t, timeout=300) for t in tickets]
    if (first.batch_size, first.bucket_n) != (1, 1):
        raise AssertionError("pipelined lone request did not run alone")
    return res


def check_results(what, res, refs) -> float:
    worst = 0.0
    for r, (ref, scale) in zip(res, refs):
        worst = max(worst, check_close(what, torch.from_numpy(r.y),
                                       torch.from_numpy(ref).float(),
                                       torch.from_numpy(scale).float()))
    return worst


def span_seconds() -> dict:
    """Host seconds per traced span name (a span's time includes the
    spans nested in it; pipelined spans overlap across threads)."""
    out: dict = {}
    for buf in obs.TRACER.buffers():
        for ph, name, _, _, dur_ns, _, _ in buf.events:
            if ph == "X":
                out[name] = out.get(name, 0.0) + dur_ns / 1e9
    return out


def bound_ms(plan, n: int, passes: int = 1) -> tuple[float, str]:
    """Least time for the product on this card: the stream's bytes (idx
    4 B + value per slot), x read once and y written once, over the memory
    rate, or its flops over the fp32 rate, whichever is larger.  With
    ``passes`` > 1 the stream is counted once per row-window pass of the SpMM
    (the bound of that design, printed beside the function's own)."""
    cfg = plan.config
    slots = int(plan.idx.size)
    live = int(np.count_nonzero(plan.idx != -1))
    x_rows = plan.num_segments_local * cfg.segment_width
    nbytes = (passes * (slots * (4 + cfg.value_bytes) + 4 * plan.idx.shape[1])
              + 4 * n * (x_rows + plan.out_rows_padded))
    flops = 2 * live * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# -- the SpMM kernel: plans, checks, build report ---------------------------
# Served batch widths (powers of two up to the service's max_bucket).
SPMM_NS = (2, 4, 8, 16)


def spmm_plan_on_card(x, geo):
    l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
    return ks.spmm_plan(x, geo["num_rows_padded"], l2)


def check_spmm(what, idx, val, seg, x, geo, tpc) -> tuple[float, str]:
    """:func:`ks.spmm` against its plain version, and the same stream with
    its first live tile emptied, which must fail the same check.  The
    vector width that ran is read from the per-width counter and must be
    the plan's, once per pass.  Returns the error and the line to print."""
    plan = spmm_plan_on_card(x, geo)
    before = dict(ks.spmm_launches_by_width)
    got = ks.spmm(idx, val, seg, x, tiles_per_chunk=tpc, **geo)
    torch.cuda.synchronize()
    moved = {v: c - before[v] for v, c in ks.spmm_launches_by_width.items()
             if c != before[v]}
    if moved != {plan.vec: len(plan.windows)}:
        raise AssertionError(f"{what}: launches by width {moved}, the plan "
                             f"is {plan}")
    want = ks.spmm_plain(idx, val, seg, x, **geo)
    scale = ks.spmm_plain(idx, val.abs(), seg, x.abs(), **geo)
    err = check_close(f"{what} spmm kernel vs plain", got, want, scale)
    first = int(torch.nonzero((idx != -1).flatten(1).any(1))[0])
    cut = idx.clone()
    cut[first] = -1
    ctl = ks.spmm(cut, val, seg, x, tiles_per_chunk=tpc, **geo)
    torch.cuda.synchronize()
    try:
        check_close(f"{what} control", ctl, want, scale)
    except AssertionError as fail:
        msg = str(fail)
    else:
        raise AssertionError(f"{what}: the control without tile {first} "
                             f"passes the check")
    del cut, ctl, want, scale
    return err, (
        f"N={x.shape[1]} v{plan.vec}, {len(plan.windows)} pass(es): err "
        f"{err:.3e}; control without tile {first} fails as it must "
        f"({msg.split(': ', 1)[1].split(';')[0]})")


def time_spmm(idx, val, seg, x, geo, tpc, csr, k) -> dict:
    """spmm and torch.mm on CSR, read in turns (kernel, CSR, CSR,
    kernel); means and the readings."""
    return in_turns({"kernel": functools.partial(ks.spmm, idx, val, seg, x,
                                                 tiles_per_chunk=tpc, **geo),
                     "library": functools.partial(torch.mm, csr,
                                                  x[:k].contiguous())}, 20)


# -- phase 4: the solvers -----------------------------------------------------
FUSED_EPILOGUES = {"pagerank": _pagerank_epilogue, "cg": _cg_epilogue,
                   "power": _power_epilogue}
# Iterations per timed run of a solver body: two chunks of the fused loop.
BODY_ITERS = 16
# Bytes of the state each fused step must read and write once, in units of
# one (R, LANES) fp32 vector: CG reads sol, r, p and writes them back;
# PageRank reads r and the mask and writes r; power iteration reads and
# writes v.
STATE_VECTORS = {"cg": 6, "pagerank": 3, "power": 2}


def spd_from_upper(rows, cols, vals, n):
    """The upper triangle mirrored, diagonal = row's Σ|off-diagonal| + 1:
    symmetric and strictly diagonally dominant, so SPD."""
    up = rows < cols
    r, c, v = rows[up], cols[up], vals[up]
    diag = np.bincount(np.concatenate([r, c]),
                       weights=np.abs(np.concatenate([v, v])),
                       minlength=n) + 1.0
    ar = np.arange(n, dtype=r.dtype)
    return (np.concatenate([r, c, ar]), np.concatenate([c, r, ar]),
            np.concatenate([v, v, diag.astype(np.float32)]))


def csr64(rows, cols, vals, shape):
    import scipy.sparse as sp
    return sp.csr_matrix((vals.astype(np.float64), (rows, cols)),
                         shape=shape)


def pagerank64(a, iters: int, damping: float = 0.85):
    """fp64 PageRank on the host, the solver's update, ``iters`` steps."""
    n = a.shape[0]
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        link = damping * (a @ r)
        r = link + (1.0 - link.sum()) / n
    return r


def fused_state(name, op, dev, seed):
    """x and extras of one fused step on the card: CG's first iteration
    from b, a PageRank step from 1/n, a power step from a random unit v."""
    n = op.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    if name == "cg":
        b = op.to_acc_layout(torch.randn(n, generator=g).to(dev))
        extras = (torch.zeros_like(b), b.clone(), b.clone(),
                  (b * b).sum().reshape(1, 1))
        return op.from_acc_layout(extras[2]), extras
    if name == "pagerank":
        extras = (op.to_acc_layout(torch.full((n,), 1.0 / n, device=dev)),
                  op.to_acc_layout(torch.ones(n, device=dev)),
                  torch.tensor([[0.85, n]], device=dev))
        return op.from_acc_layout(extras[0]), extras
    v = torch.randn(n, generator=g).to(dev)
    extras = (op.to_acc_layout(v / v.norm()),)
    return op.from_acc_layout(extras[0]), extras


def compare_fused(name, op, dev) -> float:
    """One fused step against ``spmv_fused_plain`` on the same inputs;
    returns the largest absolute error over acc and every output."""
    ep = FUSED_EPILOGUES[name]
    x, extras = fused_state(name, op, dev, SEED)
    idx, val, seg = op._shards[0]
    cfg = op.config
    geo = dict(num_rows_padded=op.plan.out_rows_padded,
               segment_width=cfg.segment_width)
    want_acc, want = ks.spmv_fused_plain(idx, val, seg, x, extras,
                                         epilogue=ep, **geo)
    scale = ks.spmv_plain(idx, val.abs(), seg, ops.pad_x(
        x.abs(), op.plan.num_segments_local, cfg.segment_width), **geo)
    k_extras = tuple(e.clone() for e in extras)
    kx = op.from_acc_layout(k_extras[2 if name == "cg" else 0])
    seen = set()
    acc, got = ran_plan(functools.partial(
        ks.spmv_fused, idx, val, seg, kx, k_extras, epilogue=ep,
        tiles_per_chunk=cfg.tiles_per_chunk, **geo), seen)()
    torch.cuda.synchronize()
    one_plan(f"spmv_fused[{name}]", seen,
             ks._card_spmv_plan(idx, geo["num_rows_padded"]))
    worst = check_close(f"spmv_fused[{name}] acc vs plain", acc, want_acc,
                        scale)
    n_state = len(ks._EPILOGUES[ep].state)
    for i, (g, w) in enumerate(zip(got, want)):
        if i < n_state:
            j = ks._EPILOGUES[ep].state[i]
            mag = max(float(w.abs().max()), float(extras[j].abs().max()))
            worst = max(worst, check_close(
                f"spmv_fused[{name}] state {i} vs plain", g, w,
                torch.full_like(w, mag), atol=0.0))
            continue
        if name == "power" and i == 1:       # λ = Σ v·Av: signed terms
            terms = float((extras[0] * want_acc.view_as(extras[0]))
                          .abs().sum())
        else:                                # Σ r², Σ|Δr|, ‖Av − λv‖
            terms = float(w.abs().sum())
        worst = max(worst, check_close(
            f"spmv_fused[{name}] scalar {i} vs plain", g, w,
            torch.full_like(w, terms)))
    return worst


def solver_bodies(name, op, dev) -> dict:
    """The solvers' own fused and unfused loop bodies (``_solve_fused``/
    ``_solve_unfused`` in ``solvers/cg.py``, ``_pagerank_*`` and
    ``_power_*`` in ``solvers/power_iteration.py``), each set up to run
    :data:`BODY_ITERS` iterations from the same start, with a stop that
    no measure reaches.  The fused body enqueues the kernel chain and
    reads the loop's control word once per chunk; the unfused one runs
    the spmv kernel, torch vector ops and a host read per iteration."""
    n = op.shape[0]
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    if name == "cg":
        b = torch.randn(n, generator=g).to(dev)
        args = (torch.zeros_like(b), b, torch.dot(b, b))
        bodies = (_solve_fused, _solve_unfused)
    elif name == "pagerank":
        args = (torch.full((n,), 1.0 / n, device=dev), 0.85)
        bodies = (_pagerank_fused, _pagerank_unfused)
    else:
        v = torch.randn(n, generator=g).to(dev)
        args = (v / v.norm(),)
        bodies = (_power_fused, _power_unfused)
    return {kind: functools.partial(body, op, *args, -1.0, BODY_ITERS, None)
            for kind, body in zip(("fused", "unfused"), bodies)}


def time_fused(name, op, dev, csr) -> dict:
    """CUDA-event ms of one fused step (the kernel chain), of one
    iteration of the solvers' fused and unfused bodies
    (:func:`solver_bodies`), of the plain version, and of ``torch.mv`` on
    CSR + the epilogue in torch ops."""
    ep = FUSED_EPILOGUES[name]
    cfg = op.config
    idx, val, seg = op._shards[0]
    geo = dict(num_rows_padded=op.plan.out_rows_padded,
               segment_width=cfg.segment_width)
    x, extras = fused_state(name, op, dev, SEED + 1)
    loop = ks.FusedLoop(dev, stop=-float("inf"), max_iters=1 << 30,
                        scalars=(0.0,) * ks._EPILOGUES[ep].scalars)

    seen = set()
    fused = ran_plan(functools.partial(
        ks.spmv_fused, idx, val, seg, x, extras, epilogue=ep, loop=loop,
        tiles_per_chunk=cfg.tiles_per_chunk, **geo), seen)

    lanes = cfg.lanes
    m = op.shape[0]
    buf = torch.zeros(geo["num_rows_padded"], device=dev)

    def library():
        buf[:m].copy_(torch.mv(csr, x))
        ep(buf.view(-1, lanes), *extras)

    bodies = solver_bodies(name, op, dev)
    # The fused step and the library step in turns (fused, library,
    # library, fused), each reading the state the other left.
    turns = in_turns({"fused": fused, "library": library}, 20)
    return {"ms": turns["fused"], "library_ms": turns["library"],
            "reads": turns["reads"],
            "plan": one_plan(f"timed spmv_fused[{name}]", seen,
                             ks._card_spmv_plan(idx,
                                                geo["num_rows_padded"])),
            "fused_iter_ms": time_ms(bodies["fused"], 3) / BODY_ITERS,
            "unfused_iter_ms": time_ms(bodies["unfused"], 3) / BODY_ITERS,
            "plain_ms": time_ms(functools.partial(
                ks.spmv_fused_plain, idx, val, seg, x, extras, epilogue=ep,
                **geo), 3)}


def fused_bound(name, op) -> tuple[float, str]:
    """Least time of one fused step: the stream's bytes and the state
    vectors read/written once over the memory rate, or its flops (2 per
    live slot plus ~10 per state element) over the fp32 rate."""
    plan, cfg = op.plan, op.config
    slots = int(plan.idx.size)
    live = int(np.count_nonzero(plan.idx != -1))
    rp = plan.out_rows_padded
    nbytes = (slots * (4 + cfg.value_bytes) + 4 * plan.idx.shape[1]
              + 4 * STATE_VECTORS[name] * rp)
    flops = 2 * live + 10 * rp
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def zero_launches() -> None:
    ks.spmv_launches = ks.spmm_launches = ks.spmv_fused_launches = 0
    for vec in ks.spmm_launches_by_width:
        ks.spmm_launches_by_width[vec] = 0
    fa.flash_launches = fa.flash_bwd_launches = 0
    for body in fa.flash_launches_by_body:
        fa.flash_launches_by_body[body] = 0


def read_launches() -> dict:
    return {"spmv": ks.spmv_launches, "spmm": ks.spmm_launches,
            "spmv_fused": ks.spmv_fused_launches,
            "flash_attention": fa.flash_launches,
            "flash_attention_bwd": fa.flash_bwd_launches}


def phase_solvers(reg, svc, rows, cols, vals, shape, dev, t_run, card):
    """Phase 4; returns (launches, max error, timings, bounds) of the
    fused kernel's main-path runs."""
    t = time.perf_counter()
    m = shape[0]
    gv = column_normalize(rows, cols, vals, m)
    pmid, _ = gated_put(reg, "G7 column-normalised", rows, cols, gv, shape,
                        "sentinel")
    pop = reg.get(pmid)
    say(f"[phase4] G7 column-normalised: registry put "
        f"{time.perf_counter() - t:.1f} s, fusable "
        f"{pop.supports_fused_epilogue}")

    g5_scale = 1.0
    if time.perf_counter() - t_run > SLOW_RUN_S:
        g5_scale = G5_SMALL_SCALE
        say(f"[phase4] run past {SLOW_RUN_S:.0f} s: G5 at scale {g5_scale}")
    t = time.perf_counter()
    r5, c5, v5, shape5, _ = paper_matrix("G5", scale=g5_scale, seed=SEED)
    sr, sc, sv = spd_from_upper(r5, c5, v5, shape5[0])
    n5 = shape5[0]
    smid, _ = gated_put(reg, f"G5 SPD x{g5_scale}", sr, sc, sv, shape5,
                        "seg-monotone")
    sop = reg.get(smid)
    say(f"[phase4] G5 stand-in SPD {n5} x {n5}, nnz {sv.size}, scale "
        f"{g5_scale}: generated and put in {time.perf_counter() - t:.1f} s")
    b = np.random.default_rng(SEED + 2).standard_normal(n5) \
        .astype(np.float32)

    solves = {"pagerank": (pmid, "pagerank", dict(tol=1e-6, max_iters=200)),
              "cg": (smid, "cg", dict(b=b, tol=1e-6, timeout=600)),
              "power": (smid, "power_iteration", dict(max_iters=100))}

    def solve_all(**over):
        """Each solve through the service; host seconds per solve (the
        result is on the host when solve returns)."""
        out, secs = {}, {}
        for k, (mid_k, kind_k, kw) in solves.items():
            t0 = time.perf_counter()
            out[k] = svc.solve(mid_k, kind_k, **{**kw, **over})
            secs[k] = time.perf_counter() - t0
        return out, secs

    # Warm-up (first-use costs such as cuBLAS's handle for torch.dot stay
    # out of the timed solves), then the main path: every solve fused,
    # counts from 0.
    solve_all(max_iters=2)
    solve_all(max_iters=2, fused=False)
    zero_launches()
    torch.cuda.synchronize()
    runs, secs = solve_all()
    torch.cuda.synchronize()
    launches = read_launches()
    iters = {k: r.solve.iterations for k, r in runs.items()}
    say(f"[phase4] fused solves: iterations {iters}, launches {launches}, "
        f"host syncs per solve "
        f"{ {k: r.solve.host_syncs for k, r in runs.items()} }, seconds "
        f"{ {k: round(v, 4) for k, v in secs.items()} }, ms per iteration "
        f"{ {k: round(1e3 * secs[k] / max(iters[k], 1), 4) for k in secs} }"
        f"  [{card}]")
    for k, r in runs.items():
        if not r.solve.fused:
            raise AssertionError(f"{k} did not run fused")
    if launches["spmv_fused"] < sum(iters.values()):
        raise AssertionError(f"spmv_fused launched {launches} times for "
                             f"{iters} iterations")
    pr, cg, pw = runs["pagerank"], runs["cg"], runs["power"]
    if not (pr.solve.converged and cg.solve.converged):
        raise AssertionError("PageRank or CG did not converge")

    # Against fp64 host references.
    t = time.perf_counter()
    a7 = csr64(rows, cols, gv, shape)
    r64 = pagerank64(a7, pr.solve.iterations)
    r_err = check_close("G7 PageRank vs fp64", torch.from_numpy(pr.y),
                        torch.from_numpy(r64).float(),
                        torch.full((m,), float(r64.max())), atol=1e-9)
    if abs(float(pr.y.sum()) - 1.0) >= 1e-3:
        raise AssertionError(f"PageRank sums to {float(pr.y.sum())}")
    a5 = csr64(sr, sc, sv, shape5)
    x64 = cg.y.astype(np.float64)
    true_res = float(np.linalg.norm(b - a5 @ x64) / np.linalg.norm(b))
    if true_res > 1e-4:
        raise AssertionError(f"CG true residual {true_res}")
    v64 = pw.y.astype(np.float64)
    rq = float(v64 @ (a5 @ v64) / (v64 @ v64))
    lam_rel = abs(pw.solve.eigenvalue - rq) / abs(rq)
    if lam_rel > 1e-4:
        raise AssertionError(f"power λ {pw.solve.eigenvalue} vs fp64 "
                             f"Rayleigh quotient {rq}")
    say(f"[phase4] vs fp64 ({time.perf_counter() - t:.1f} s): PageRank "
        f"max err {r_err:.3e} (sum {float(pr.y.sum()):.7f}, delta "
        f"{pr.solve.residual:.3e}); CG true residual {true_res:.3e} "
        f"(recursive {cg.solve.residual / np.linalg.norm(b):.3e}); power "
        f"λ {pw.solve.eigenvalue:.6f} vs {rq:.6f} (rel {lam_rel:.2e}, "
        f"residual {pw.solve.residual:.3e})")

    # Fused against unfused on the card.
    un, usecs = solve_all(fused=False)
    for k, u in un.items():
        if abs(u.solve.iterations - iters[k]) > 1:
            raise AssertionError(f"{k}: unfused {u.solve.iterations} vs "
                                 f"fused {iters[k]} iterations")
    pe = check_close("G7 PageRank fused vs unfused",
                     torch.from_numpy(pr.y),
                     torch.from_numpy(un["pagerank"].y),
                     torch.full((m,), float(pr.y.max())), atol=1e-9)
    # CG and power iteration: both runs stop within 1e-6 of a solution of
    # the same system, so they agree to ~κ·1e-6 of the solution's scale.
    ce = check_close("G5 CG fused vs unfused", torch.from_numpy(cg.y),
                     torch.from_numpy(un["cg"].y),
                     torch.full((n5,), 100.0 * float(np.abs(cg.y).max())))
    lam_un = abs(un["power"].solve.eigenvalue - pw.solve.eigenvalue) \
        / abs(pw.solve.eigenvalue)
    if lam_un > 1e-5:
        raise AssertionError(f"power λ fused vs unfused rel {lam_un}")
    ums = {k: round(1e3 * usecs[k] / max(u.solve.iterations, 1), 4)
           for k, u in un.items()}
    say(f"[phase4] unfused solves: iterations "
        f"{ {k: u.solve.iterations for k, u in un.items()} }, host syncs "
        f"{ {k: u.solve.host_syncs for k, u in un.items()} }, ms per "
        f"iteration {ums}  [{card}]; PageRank "
        f"max |fused - unfused| {pe:.3e}, CG {ce:.3e}, power λ rel "
        f"{lam_un:.2e}")

    # Kernel against plain, one step per epilogue at the main shapes.
    t = time.perf_counter()
    ops_by = {"pagerank": pop, "cg": sop, "power": sop}
    err = max(compare_fused(k, ops_by[k], dev) for k in FUSED_EPILOGUES)
    say(f"[phase4] fused step vs plain (G7 pagerank, G5 cg/power): max "
        f"err {err:.3e} in {time.perf_counter() - t:.1f} s")

    # Timings.
    t = time.perf_counter()
    with warnings.catch_warnings():     # torch.sparse's beta notices
        warnings.simplefilter("ignore", UserWarning)
        csr7 = torch.sparse_csr_tensor(
            torch.from_numpy(a7.indptr).long(),
            torch.from_numpy(a7.indices).long(),
            torch.from_numpy(a7.data).float(), shape).to(dev)
        csr5 = torch.sparse_csr_tensor(
            torch.from_numpy(a5.indptr).long(),
            torch.from_numpy(a5.indices).long(),
            torch.from_numpy(a5.data).float(), shape5).to(dev)
    csr_by = {"pagerank": csr7, "cg": csr5, "power": csr5}
    times, bounds = {}, {}
    for k in FUSED_EPILOGUES:
        times[k] = time_fused(k, ops_by[k], dev, csr_by[k])
        bounds[k] = fused_bound(k, ops_by[k])
        tm, (bd, by) = times[k], bounds[k]
        where = "G7" if k == "pagerank" else f"G5 x{g5_scale}"
        reads = ", ".join(f"{n} " + " / ".join(f"{x:.4f}" for x in r)
                          for n, r in tm["reads"].items())
        pl = tm["plan"]
        say(f"[phase4] {k} step ({where}): fused {tm['ms']:.4f} ms (stream "
            f"pass: {pl.lane_group} lanes a block, {len(pl.windows)} "
            f"window(s), {pl.splits} split(s)), readings in turns with "
            f"CSR + epilogue: {reads}; per iteration of the solver's fused "
            f"body "
            f"{tm['fused_iter_ms']:.4f} ms and unfused body "
            f"{tm['unfused_iter_ms']:.4f} ms "
            f"({tm['unfused_iter_ms'] / tm['fused_iter_ms']:.2f}x), plain "
            f"{tm['plain_ms']:.4f} ms, torch.sparse CSR + epilogue "
            f"{tm['library_ms']:.4f} ms, bound {bd:.4f} ms ({by}); "
            f"{bd / tm['ms']:.3f} of the bound  [{card}]")
    say(f"[phase4] timings in {time.perf_counter() - t:.1f} s")
    return launches, max(err, 0.0), times, bounds

# -- phase 5: LM serving through the flash-attention kernel -------------------
LM_ARCH = "qwen1.5-0.5b"
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2000, 16
# Elementwise flash kernel vs plain: |Δ| <= atol + rtol·|plain|.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 kernel vs plain in norm: ||Δ|| <= FLASH_BF16_REL·||plain||, about
# 3x the first readings (1.4e-3 and 1.6e-3).  A control (the plain output
# with one 64-key tile left out of the last 64 queries, a kernel that
# skips a kv tile; it read 1.3e-2) must fail it.
FLASH_BF16_REL = 5e-3
# Each in-turn reading of :func:`time_flash` spans at least this many ms
# of calls, so that a call of tens of µs is not timed on a handful.
FLASH_READ_MS = 10.0
# (name, b, s, kv heads, g, dh, dv, causal, dtype) of phase 5(a).
FLASH_CASES = (
    ("qwen heads", 4, 2000, 16, 1, 64, 64, True, torch.bfloat16),
    ("qwen heads", 4, 2000, 16, 1, 64, 64, True, torch.float32),
    ("chatglm3 heads", 1, 4096, 2, 16, 128, 128, True, torch.bfloat16),
    ("non-causal", 2, 1000, 16, 1, 64, 64, False, torch.float32),
    ("dv != dh", 2, 1000, 4, 2, 96, 64, True, torch.float32),
    ("minicpm3 MLA heads", 4, 2000, 40, 1, 96, 64, True, torch.bfloat16),
)
# Largest |Δ| allowed between the last-position logits of the bf16 prefill
# with the kernel and with the plain attention: about 3x the first H100
# run's 7.7e-2 (bf16 attention outputs rounded at other points, carried
# through 24 layers).
LM_BF16_LOGIT_TOL = 0.25
# The same two prefills in norm, on the last layer's attention mixer
# output: ||Δ|| <= LM_BF16_ATTN_REL·||plain||, about 4.5x the first
# reading (4.4e-3).  Two controls must fail it: every layer's attention
# non-causal, and layer 0's attention zeroed (they read 1.0 and 0.94).
# Both fail the logits bound as well (3.2 and 2.9).
LM_BF16_ATTN_REL = 2e-2
# Prefill/decode consistency in fp32: the largest |Δ| of the logits, and
# the last layer's attention mixer output in norm, each about 10x the
# first reading (9.7e-6 and 7.0e-7).  A control (one decode step at the
# position after the right one; it read 8.3e-2 and 7.5e-3) must fail both.
LM_FP32_DECODE_TOL = 1e-4
LM_FP32_ATTN_REL = 1e-5


def attention_inputs(b, s, kvh, g, dh, dv, dtype, dev, seed, sk=None):
    """Seeded q (B, S, KV, G, dh), k and v (B, Sk, KV, dh | dv); Sk = S
    unless given."""
    sk = sk or s
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, kvh, g, dh), generator=gen, device=dev)
    k = torch.randn((b, sk, kvh, dh), generator=gen, device=dev)
    v = torch.randn((b, sk, kvh, dv), generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def check_allclose(what, got, want, tol) -> float:
    """Elementwise ``|got - want| <= tol + tol·|want|``; returns the
    largest absolute error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite values")
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements out of "
                             f"tolerance {tol}; max |err| {float(err.max())}")
    return float(err.max())


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite values")
    return float((got - want).norm() / want.norm())


def dropped_tile_control(q, k, v, want, rows=64, tile=64, causal=True):
    """``want`` (the plain output; causal ones have Sq = Sk) with one
    middle ``tile``-key tile left out of the last ``rows`` queries: what a
    kernel that skips a kv tile would give."""
    s = q.shape[1]
    t0 = k.shape[1] // 2 // tile * tile
    kd = torch.cat([k[:, :t0], k[:, t0 + tile:]], 1)
    vd = torch.cat([v[:, :t0], v[:, t0 + tile:]], 1)
    ctl = want.clone()
    # Keys past the tile move down by ``tile``; the queries' offset moves
    # with them, so the causal mask keeps its pairs.
    ctl[:, -rows:] = attn.chunked_attention(
        q[:, -rows:], kd, vd, causal=causal, q_offset=s - rows - tile,
        chunk=rows)
    return ctl


@contextlib.contextmanager
def patched(module, name, replacement):
    """``module.name`` replaced for the block's duration."""
    orig = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def last_mixer_output(attention=None):
    """Records the attention mixer's output (B, S, D) of every layer of a
    prefill or decode step into the yielded list; ``attention`` (optional)
    stands in for the flash kernel in the prefill."""
    outs = []

    def recording(fn):
        def rec(*args, **kwargs):
            r = fn(*args, **kwargs)
            outs.append(r[0])
            return r
        return rec

    with contextlib.ExitStack() as stack:
        for name in ("attn_forward", "attn_decode"):
            stack.enter_context(patched(attn, name,
                                        recording(getattr(attn, name))))
        if attention is not None:
            stack.enter_context(patched(fa, "flash_attention", attention))
        yield outs


def flash_bound(b, s, kvh, g, dh, dv, causal, dtype_bytes=2, sk=None,
                prefix=0):
    """Least time of one call: q, k, v read once and o written once over
    the memory rate, or the flops of the unmasked (q, k) pairs (2·dh for
    the score, 2·dv for P·V) over the bf16 tensor-core rate.  Sk = S
    unless given (non-causal only); under causal row r sees
    max(r + 1, ``prefix``) keys."""
    sk = sk or s
    if causal and sk != s:
        raise ValueError("a causal bound is counted at Sq = Sk")
    seen = (np.minimum(s, np.maximum(np.arange(1, s + 1), prefix)).sum()
            if causal else s * sk)
    pairs = b * kvh * g * int(seen)
    nbytes = dtype_bytes * b * kvh * (s * g * (dh + dv) + sk * (dh + dv))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * (dh + dv) * pairs / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sdpa_backend(call) -> str:
    """The backend that ``call`` (a ``functools.partial`` of
    ``scaled_dot_product_attention``) runs on, as its dispatcher chooses
    it (``torch._fused_sdp_choice``), e.g. ``cudnn_attention``."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(*call.args,
                                              **call.keywords)).name.lower()


def time_flash(b, s, kvh, g, dh, causal, dev, iters, dv=None,
               sk=None, prefix=0) -> dict:
    """CUDA-event ms of the flash bodies that take these head dims (the
    body ``flash_body`` names for the tensors, and when that is the wgmma
    body also the mma body on an offset copy of the same tensors),
    ``scaled_dot_product_attention`` (a yardstick the port never calls, on
    the same bf16 tensors viewed as (B, H, S, dh); with a ``prefix`` it
    takes the same prefix-LM mask as a boolean ``attn_mask``, and is also
    timed causal without the prefix as ``"library causal"``) and the plain
    version, with Sk = S unless given.  All but the plain run in turns, in
    one order and then the reverse, ``iters[0]`` calls a reading or enough
    that the fastest spans ``FLASH_READ_MS``, queued behind a spin kernel
    (:func:`queued_ms`); each reports the mean of its two readings.
    ``"backend"`` names the library's backend (:func:`sdpa_backend`)."""
    dv = dv or dh
    q, k, v = attention_inputs(b, s, kvh, g, dh, dv, torch.bfloat16, dev,
                               SEED + 5, sk=sk)
    inputs = {fa.flash_body(q, k, v): (q, k, v)}
    if "wgmma" in inputs:
        inputs["mma"] = tuple(map(offset_copy, (q, k, v)))
    if any(fa.flash_body(*t) != body for body, t in inputs.items()):
        raise AssertionError("the timed tensors do not reach the bodies "
                             f"{list(inputs)}")
    p = functools.partial
    runs = {body: p(fa.flash_attention, *t, causal=causal, prefix_len=prefix)
            for body, t in inputs.items()}
    sdpa = p(torch.nn.functional.scaled_dot_product_attention,
             q.view(b, s, kvh * g, dh).transpose(1, 2), k.transpose(1, 2),
             v.transpose(1, 2), enable_gqa=g > 1)
    if prefix and causal:
        kpos = torch.arange(k.shape[1], device=dev)
        mask = (kpos[None, :] <= torch.arange(s, device=dev)[:, None]) | \
            (kpos[None, :] < prefix)
        runs["library"] = p(sdpa, attn_mask=mask)
        runs["library causal"] = p(sdpa, is_causal=True)
    else:
        runs["library"] = p(sdpa, is_causal=causal)
    backend = sdpa_backend(runs["library"])
    fastest = min(queued_ms(fn, 3) for fn in runs.values())
    out = in_turns(runs, max(iters[0], int(np.ceil(FLASH_READ_MS / fastest))),
                   timer=queued_ms)
    out["plain"] = time_ms(p(fa.flash_attention_plain, q, k, v,
                             causal=causal, prefix_len=prefix), iters[1])
    out["backend"] = backend
    return out


def profile_serve(eng, batch, out, card, host_ms: dict, steps: int = 4,
                  tag: str = "phase5") -> None:
    """``torch.profiler`` over one prefill and over ``steps`` decode steps:
    the card's busy ms (kernel time summed), its share of the unprofiled
    host time in ``host_ms`` (the profiler slows the host), the kernel
    launches the profiler counted, and the kernels that take the most
    time."""
    from torch.profiler import ProfilerActivity, profile

    n = min(64, batch["inputs"].shape[1])
    pos0 = eng.lm.cfg.vision_tokens + n   # a VLM's image comes first
    _, cache = eng.prefill(dict(batch, inputs=batch["inputs"][:, :n]))
    torch.cuda.synchronize()
    for name, prefill in (("prefill", True), ("decode", False)):
        with warnings.catch_warnings(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("ignore", UserWarning)
            t = time.perf_counter()
            if prefill:
                eng.prefill(batch)
            else:
                for i in range(steps):
                    eng.decode_step(cache, out[:, i:i + 1], pos0 + i)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = {e.key: e.self_device_time_total / 1e3 for e in kernels}
        total = sum(busy.values())
        count = sum(e.count for e in kernels
                    if not e.key.startswith(("Memcpy", "Memset")))
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        per = 1 if prefill else steps
        say(f"[{tag}] profile {name} (per {'call' if prefill else 'step'}"
            f"): card busy {total / per:.3f} ms, {total / per / host_ms[name]:.2f}"
            f" of the unprofiled {host_ms[name]:.3f} ms (profiled host "
            f"{prof_ms / per:.3f} ms), {count / per:.1f} kernel launches; "
            f"top kernels: "
            + "; ".join(f"{k[:60]} {v / per:.3f} ms" for k, v in top)
            + f"  [{card}]")


def offset_copy(x):
    """x's values in a tensor that starts one element into its storage:
    contiguous but not 16-byte aligned, so the shape rule sends it to the
    mma body."""
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = base[1:].view(x.shape)
    y.copy_(x)
    return y


def launch_body(q, k, v, causal, prefix=0):
    """The kernel's output on (q, k, v) and the body that ran, read from
    the per-body counters; the body must be the one the shape rule names."""
    before = dict(fa.flash_launches_by_body)
    got = fa.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
    torch.cuda.synchronize()
    ran = [n for n, c in fa.flash_launches_by_body.items() if c != before[n]]
    if ran != [fa.flash_body(q, k, v)]:
        raise AssertionError(f"flash ran {ran}, the shape rule names "
                             f"{fa.flash_body(q, k, v)!r}")
    return got, ran[0]


def check_flash_case(case, dev, tag, sk=None, prefix=0):
    """One ``FLASH_CASES`` entry, with Sk = S unless given and
    ``prefix_len=prefix``: the kernel against its plain version on card
    tensors.  A bf16 case runs on the wgmma body at its head dims (else
    the mma body), and the wgmma body's cases on the mma body too, on an
    offset copy.  With a prefix each call is made again with
    ``prefix_len=0`` (the control), which must fail the check.  Returns
    the largest error and (q, k, v, plain)."""
    name, b, s, kvh, g, dh, dv, causal, dt = case
    q, k, v = attention_inputs(b, s, kvh, g, dh, dv, dt, dev,
                               SEED + s + prefix, sk=sk)
    runs = [(q, k, v)]
    if dt == torch.bfloat16:
        body = "wgmma" if (dh, dv) in fa.WGMMA_HEAD_DIMS else "mma"
        if fa.flash_body(q, k, v) != body:
            raise AssertionError(f"bf16 case {name} is not on the {body} "
                                 f"body")
        if body == "wgmma":
            runs.append(tuple(map(offset_copy, (q, k, v))))
    want = fa.flash_attention_plain(q, k, v, causal=causal,
                                    prefix_len=prefix)
    tol = FLASH_TOL[dt]
    err = 0.0
    for qq, kk, vv in runs:
        got, body = launch_body(qq, kk, vv, causal, prefix)
        e = check_allclose(f"flash {name} {dt} {body} vs plain", got, want,
                           tol)
        err = max(err, e)
        rel = ""
        if dt == torch.bfloat16:
            r = rel_err(got, want)
            rel = f", ||Δ||/||plain|| {r:.3e} (tol {FLASH_BF16_REL})"
            if not r <= FLASH_BF16_REL:
                raise AssertionError(f"flash {name} bf16 {body} vs plain: "
                                     f"||Δ||/||plain|| {r}")
        if prefix:
            ctl, _ = launch_body(qq, kk, vv, causal)
            rc = rel_err(ctl, want)
            out = int(((ctl.float() - want.float()).abs()
                       > tol + tol * want.float().abs()).sum())
            if not (rc > FLASH_BF16_REL if dt == torch.bfloat16 else out):
                raise AssertionError(f"the prefix_len=0 control passes the "
                                     f"{name} {body} check ({rc}, {out})")
            rel += (f"; control (prefix_len=0): ||Δ||/||plain|| {rc:.3e}, "
                    f"{out} elements out of tolerance")
            del ctl
        say(f"[{tag}] flash {body} body vs plain, {name} (B={b}, S={s}, "
            f"Sk={k.shape[1]}, KV={kvh}, G={g}, dh={dh}, dv={dv}, "
            f"causal={causal}, " + (f"prefix_len={prefix}, " if prefix
                                    else "") +
            f"{dt}): max err {e:.3e} (tol {tol}){rel}")
        del got
    return err, (q, k, v, want)


def phase_lm(dev, card):
    """Phase 5; returns (launches, max error, timings, bound, per-body
    record) of the flash kernel at the served shape."""
    pairs = sorted(fa.WGMMA_HEAD_DIMS)
    say("[phase5] flash wgmma body, ptxas: " + ptxas_report(
        "flash_attention", r"flash_fwd_wgmma_kernelILi(\d+)ELi(\d+)E",
        lambda hit: f"(dh, dv) = ({hit[1]}, {hit[2]})",
        [f"(dh, dv) = {pair}" for pair in pairs]) + "; dynamic shared "
        "memory: " + ", ".join(f"{pair} {fa.wgmma_smem_bytes(*pair)} bytes"
                               for pair in pairs))
    # (a) the kernel against its plain version on card tensors; in bf16
    # the wgmma body on the tensors and the mma body on an offset copy.
    t = time.perf_counter()
    err = 0.0
    for case in FLASH_CASES:
        name, dt = case[0], case[-1]
        e, (q, k, v, want) = check_flash_case(case, dev, "phase5")
        err = max(err, e)
        if dt == torch.bfloat16 and name in ("qwen heads",
                                             "minicpm3 MLA heads"):
            ctl = dropped_tile_control(q, k, v, want)
            r, e = rel_err(ctl, want), float((ctl.float() - want.float())
                                             .abs().max())
            say(f"[phase5] control, {name} (one 64-key tile dropped for "
                f"the last 64 queries) vs plain: ||Δ||/||plain|| {r:.3e}, "
                f"max err {e:.3e}; the bound both bodies met above fails "
                f"it")
            if not r > FLASH_BF16_REL:
                raise AssertionError(f"the bf16 norm check passes a kernel "
                                     f"that drops a kv tile ({r})")
            del ctl
        del q, k, v, want
    say(f"[phase5] kernel checks in {time.perf_counter() - t:.1f} s")

    # (b) serve: qwen1.5-0.5b at full width and depth, random bf16 weights.
    t = time.perf_counter()
    cfg = get_config(LM_ARCH)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(x.numel() for x in tree_leaves(params))
    max_len = LM_PROMPT + LM_DECODE + 1
    eng = ServeEngine(lm, params, max_len=max_len)
    rng = np.random.default_rng(SEED + 3)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 4))).to(dev)
    batch = {"inputs": prompts[:, :LM_PROMPT]}
    eng.generate({"inputs": prompts[:, :64]}, 2)        # warm-up
    torch.cuda.synchronize()
    say(f"[phase5] {LM_ARCH}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{cfg.num_heads} heads (KV {cfg.num_kv_heads}), dh={cfg.head_dim},"
        f" vocab {cfg.vocab_padded}, {n_params / 1e6:.1f} M params in bf16,"
        f" made on the card in {time.perf_counter() - t:.1f} s")

    zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = eng.generate(batch, LM_DECODE + 1)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    launches = read_launches()
    by_body = dict(fa.flash_launches_by_body)
    if launches["flash_attention"] != cfg.num_layers or \
            by_body["wgmma"] != cfg.num_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times in the "
                             f"serve ({by_body}), not the wgmma body once "
                             f"per layer ({cfg.num_layers})")
    if tuple(out.shape) != (LM_BATCH, LM_DECODE + 1) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of "
                             f"range [{int(out.min())}, {int(out.max())}]")

    # Prefill alone, then the decode steps alone, on the host clock.
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = eng.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    tok = out[:, :1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(LM_DECODE):
        _, cache = eng.decode_step(cache, tok, LM_PROMPT + i)
        tok = out[:, i + 1:i + 2]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / LM_DECODE
    say(f"[phase5] serve {LM_BATCH} x {LM_PROMPT} tokens + {LM_DECODE} "
        f"greedy decode steps: generate {gen_s:.3f} s, launches {launches};"
        f" prefill {prefill_ms:.2f} ms ({LM_BATCH * LM_PROMPT / prefill_ms:.1f}"
        f" tokens/ms), decode {decode_ms:.3f} ms per step "
        f"({LM_BATCH * 1e3 / decode_ms:.1f} tokens/s)  [{card}]")
    say(f"[phase5] request 0's tokens: {out[0].tolist()}")
    profile_serve(eng, batch, out, card,
                  {"prefill": prefill_ms, "decode": decode_ms})

    # The same prefill with the plain attention in the kernel's place, and
    # two controls that a wrong attention must not pass.
    del cache, logits
    plain = fa.flash_attention_plain

    def non_causal(q, k, v, *, causal=True, prefix_len=0):
        return plain(q, k, v, causal=False)

    zeroed = []

    def layer0_zeroed(q, k, v, *, causal=True, prefix_len=0):
        o = plain(q, k, v, causal=causal, prefix_len=prefix_len)
        if not zeroed:
            zeroed.append(True)
            o = torch.zeros_like(o)
        return o

    runs = {}
    for run, attention in (("kernel", None), ("plain", plain),
                           ("non-causal", non_causal),
                           ("layer 0 zeroed", layer0_zeroed)):
        with last_mixer_output(attention) as outs:
            run_logits, _ = eng.prefill(batch)
        runs[run] = (run_logits, outs[-1])
        del outs[:-1]
    plain_logits, plain_out = runs.pop("plain")
    real = plain_logits[:, :cfg.vocab_size]
    say(f"[phase5] bf16 prefill vs the same with plain attention (logits "
        f"in [{float(real.min()):.3f}, {float(real.max()):.3f}]):")
    for run, (run_logits, out) in runs.items():
        d_logits = float((run_logits - plain_logits).abs().max())
        same = float((run_logits.argmax(-1) == plain_logits.argmax(-1))
                     .float().mean())
        r = rel_err(out, plain_out)
        say(f"[phase5]   {run}: last-position logits max |Δ| "
            f"{d_logits:.4e} (tol {LM_BF16_LOGIT_TOL}), greedy agreement "
            f"{same:.2f}; last layer's attention output ||Δ||/||plain|| "
            f"{r:.4e} (tol {LM_BF16_ATTN_REL})")
        if run == "kernel":
            if not (d_logits <= LM_BF16_LOGIT_TOL and r <= LM_BF16_ATTN_REL):
                raise AssertionError(f"bf16 prefill with the kernel differs "
                                     f"from plain: logits {d_logits}, "
                                     f"attention output {r}")
        elif not r > LM_BF16_ATTN_REL:
            raise AssertionError(f"control {run!r} passes the bf16 "
                                 f"attention-output check ({r})")
    del runs, plain_logits, plain_out

    # Prefill/decode consistency in fp32 at full width.
    t = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    lm32 = LM(cfg32)
    params32 = tree_map(lambda x: x.float(), params)
    del params, eng

    def prefill32(n):
        with last_mixer_output() as outs:
            lg, c = lm32.prefill(params32, {"inputs": prompts[:, :n]},
                                 max_len)
        return lg, c, outs[-1][:, -1:]

    def decode32(c, i, pos):
        with last_mixer_output() as outs:
            lg, _ = lm32.decode_step(
                params32, c, prompts[:, LM_PROMPT + i:LM_PROMPT + i + 1], pos)
        return lg, outs[-1]

    # Step i's logits and last-layer mixer output, held against a prefill
    # of the prompt extended by i tokens.  The control decodes step 0's
    # token one position too far, on a copy of the cache.
    logits, cache, out = prefill32(LM_PROMPT)
    ctl = decode32(tree_map(torch.clone, cache), 0, LM_PROMPT + 1)
    worst, worst_rel = 0.0, 0.0
    for i in range(4):
        ref, _, ref_out = prefill32(LM_PROMPT + i)
        worst = max(worst, float((logits - ref).abs().max()))
        worst_rel = max(worst_rel, rel_err(out, ref_out))
        if i == 1:
            ctl_d, ctl_rel = (float((ctl[0] - ref).abs().max()),
                              rel_err(ctl[1], ref_out))
        logits, out = decode32(cache, i, LM_PROMPT + i)
    say(f"[phase5] fp32 decode vs prefill of the longer prompt, 4 steps: "
        f"logits max |Δ| {worst:.3e} (tol {LM_FP32_DECODE_TOL}), last "
        f"layer's attention output ||Δ||/||prefill|| {worst_rel:.3e} (tol "
        f"{LM_FP32_ATTN_REL}); control (decoded one position too far): "
        f"{ctl_d:.3e} and {ctl_rel:.3e}; in {time.perf_counter() - t:.1f} s")
    if not (worst <= LM_FP32_DECODE_TOL and worst_rel <= LM_FP32_ATTN_REL):
        raise AssertionError(f"fp32 decode vs prefill differ: logits "
                             f"{worst}, attention output {worst_rel}")
    if not (ctl_d > LM_FP32_DECODE_TOL and ctl_rel > LM_FP32_ATTN_REL):
        raise AssertionError(f"a decode at the wrong position passes the "
                             f"fp32 consistency check ({ctl_d}, {ctl_rel})")
    del params32, cache, lm32, ctl

    # (c) timings with CUDA events.
    t = time.perf_counter()
    shapes = {"smoke": (LM_BATCH, LM_PROMPT, (20, 3)),
              "prefill_32k": (1, 32768, (3, 1))}
    times, bounds = {}, {}
    for key, (b, s, iters) in shapes.items():
        times[key] = tm = time_flash(b, s, cfg.num_kv_heads, 1, cfg.head_dim,
                                     True, dev, iters)
        bounds[key] = bd, by = flash_bound(
            b, s, cfg.num_kv_heads, 1, cfg.head_dim, cfg.head_dim, True)
        tb = fa.traffic_bytes(b, s, s, cfg.num_kv_heads, 1, cfg.head_dim,
                              cfg.head_dim) / HBM_BYTES_PER_S * 1e3
        reads = ", ".join(f"{n} " + " / ".join(f"{x:.4f}" for x in r)
                          for n, r in tm["reads"].items())
        wg, mma, lib = tm["wgmma"], tm["mma"], tm["library"]
        say(f"[phase5] flash {key} (B={b}, S={s}, qwen heads, bf16, "
            f"causal): wgmma body {wg:.4f} ms ({bd / wg:.3f} of the bound),"
            f" mma body {mma:.4f} ms ({bd / mma:.3f}), "
            f"scaled_dot_product_attention {lib:.4f} ms ({bd / lib:.3f}), "
            f"plain {tm['plain']:.4f} ms; bound {bd:.4f} ms ({by}; the "
            f"reference's traffic_bytes over HBM {tb:.4f} ms); wgmma "
            f"{mma / wg:.2f}x the mma body's speed, {lib / wg:.2f}x the "
            f"library's; readings in turns: {reads}  [{card}]")
    say(f"[phase5] timings in {time.perf_counter() - t:.1f} s")
    smoke = times["smoke"]
    row = {"ms": smoke["wgmma"], "plain_ms": smoke["plain"],
           "library_ms": smoke["library"]}
    bodies = {body: {"launches": by_body[body]} for body in by_body}
    for body in ("wgmma", "mma"):
        for key in shapes:
            bodies[body][key] = {"ms": times[key][body],
                                 "bound_ms": bounds[key][0],
                                 "library_ms": times[key]["library"]}
    return launches, err, row, bounds["smoke"], bodies


# -- phase 6: auto-tuned serving ------------------------------------------
# The arms are measured on the G7 stand-in at this scale instead of full
# size when the run has passed SLOW_RUN_S seconds before phase 6; the
# scaled matrix must land in the full-size matrix's feature bucket.
ARMS_SMALL_SCALE = 0.25
# Served requests per timed SpMM of an arm (the service's max_bucket).
ARM_N = 16
# Observations on the served matrix between two re-tunes in phase 6(c).
RETUNE_EVERY = 4


def tile_dropped(op):
    """A control: the operator with the first live tile of its first
    shard's stream emptied (a copy on the card; the rest is shared)."""
    ctl = copy.copy(op)
    idx, val, seg = op._shards[0]
    first = int(torch.nonzero((idx != -1).flatten(1).any(1))[0])
    cut = idx.clone()
    cut[first] = -1
    ctl._shards = [(cut, val, seg)] + op._shards[1:]
    return ctl, first


def check_arm(what, op, reqs, refs) -> float:
    """The arm's full product (stream, aux spill, row_perm, CompY) on the
    first 4 requests against their fp64 references; its tile-dropped
    control must fail the same check."""
    worst = 0.0
    for (x, a, b, y, _), (ref, scale) in zip(reqs[:4], refs[:4]):
        got = op(x, alpha=a, beta=b, y=y)
        worst = max(worst, check_close(
            what, got.cpu(), torch.from_numpy(ref).float(),
            torch.from_numpy(scale).float()))
    ctl, first = tile_dropped(op)
    x, a, b, y, _ = reqs[0]
    ref, scale = refs[0]
    try:
        check_close(f"{what} control", ctl(x, alpha=a, beta=b, y=y).cpu(),
                    torch.from_numpy(ref).float(),
                    torch.from_numpy(scale).float())
    except AssertionError:
        return worst
    raise AssertionError(f"{what}: the control without tile {first} "
                         f"passes the check")


def arm_bound_ms(plan, m: int, k: int, n: int) -> float:
    """The arm's stream read once (aux spill included), its seg ids, X
    read once and Y written once, over the memory rate (every arm is
    bound by bytes: 2 flops a slot are far below the fp32 rate)."""
    nbytes = plan.stream_bytes + 4 * plan.seg_ids.size + 4 * n * (m + k)
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_autotune(rows, cols, vals, shape, reqs, refs, dev, t_run, card):
    """Phase 6: ``put(spec="auto")`` of the full-size G7 stand-in, every
    arm of its bucket checked and timed on the card and fed to the tuner,
    a re-tune onto the best-measured arm, then the 48-request mix served
    through the auto-tuned entry with ``retune_every``.  Returns the
    served run's launches, its SpMM launches by vector width, and the
    default arm's spmv ms (``None`` when the arms were measured on a
    smaller matrix) with its origin."""
    m, k = shape
    tuner = PlanTuner(backend=ops.resolve_backend("auto", dev), seed=SEED)
    reg = MatrixRegistry(byte_budget=32 << 30, device=dev, tuner=tuner,
                         verify="fast")
    # (a) the auto put, traced for its tune/encode/verify/bind seconds.
    mid, put_s = gated_put(reg, "G7 put(spec='auto')", rows, cols, vals,
                           shape, "seg-monotone", spec="auto")
    spans = span_seconds()
    first = reg.tune_decision(mid)
    op0 = reg.get(mid)
    say(f"[phase6] put(spec='auto') of G7 {m} x {k} in {put_s:.1f} s: tune "
        f"{spans.get('tune', 0.0):.1f} s (prepare + features + choice), "
        f"encode {spans.get('encode', 0.0):.1f} s, verify "
        f"{spans.get('verify', 0.0):.3f} s, bind "
        f"{spans.get('bind', 0.0):.1f} s")
    say(f"[phase6] bucket {first.bucket}; ranked {list(first.ranked)}; "
        f"chose {first.candidate.key} (explored {first.explored})")

    # (b) every arm of the bucket, from one prepared sort.
    t = time.perf_counter()
    scale = 1.0
    if time.perf_counter() - t_run > SLOW_RUN_S:
        scale = ARMS_SMALL_SCALE
    if scale == 1.0:
        ar, ac, av, ashape = rows, cols, vals, shape
        arefs = refs
        areqs = reqs
    else:
        ar, ac, av, ashape, _ = paper_matrix("G7", scale=scale, seed=SEED)
        areqs = make_requests(np.random.default_rng(SEED + 2), *ashape)
        av64 = av.astype(np.float64)
        arefs = [host_reference(ar, ac, av64, ashape[0], x, a, b, y)
                 for x, a, b, y, _ in areqs[:4]]
    cfg = reg.default_config
    prep = sformat.prepare(ar, ac, av, ashape, cfg)
    feats = features_of(prep)
    say(f"[phase6] arms measured on G7 at scale {scale} "
        f"({ashape[0]} x {ashape[1]}, nnz {av.size}); features "
        f"{json.dumps(feats.to_dict())}")
    if feats.bucket() != first.bucket:
        raise AssertionError(f"the arms' matrix is in bucket "
                             f"{feats.bucket()}, the served one in "
                             f"{first.bucket}")
    arms = {}
    for cand in tuner.candidates(feats):
        ta = time.perf_counter()
        if scale == 1.0 and cand.key == first.candidate.key:
            aop = op0                   # the registry's own binding
        else:
            acfg = cand.apply_config(cfg)
            aprep = (prep if acfg == cfg
                     else dataclasses.replace(prep, config=acfg))
            aop = SerpensOperator(cpart.plan_from_prepared(aprep, cand.spec),
                                  device=dev)
        err = check_arm(f"arm {cand.key} vs fp64", aop, areqs, arefs)
        rp = aop.plan.out_rows_padded
        arms[cand.key] = {"cand": cand, "op": aop, "err": err, "plans": [
            ks._card_spmv_plan(sidx, rp) for sidx, _, _ in aop._shards]}
        say(f"[phase6] arm {cand.key}: {aop.plan.num_shards} shard(s), "
            f"{aop.padded_slots} slots, padding {aop.padding_ratio:.3f}, "
            f"{aop.plan.n_aux} spilled, {aop.stream_bytes / 1e6:.1f} MB; "
            f"vs fp64 max err {err:.3e}, control fails as it must; built "
            f"and checked in {time.perf_counter() - ta:.1f} s")
    xd = torch.from_numpy(areqs[0][0]).to(dev)
    xn = torch.from_numpy(np.stack([r[0] for r in areqs[:ARM_N]], 1)).to(dev)
    fns, seen = {}, {}
    for key, arm in arms.items():
        seen[key] = set()
        fns[f"{key} spmv"] = ran_plan(functools.partial(arm["op"].matvec,
                                                        xd), seen[key])
        fns[f"{key} spmm"] = functools.partial(arm["op"].matmat, xn)
    turns = in_turns(fns, 20)
    for key, arm in arms.items():
        op = arm["op"]
        plan = one_plan(f"arm {key} spmv", seen[key], arm["plans"][-1])
        arm["spmv_ms"] = turns[f"{key} spmv"]
        arm["spmm_ms"] = turns[f"{key} spmm"]
        t_spmm = arm["spmm_ms"] / 1e3
        tuner.observe(first.bucket, arm["cand"],
                      slots_per_s=op.padded_slots / t_spmm,
                      requests_per_s=ARM_N / t_spmm)
        say(f"[phase6] arm {key}: spmv {arm['spmv_ms']:.4f} ms (bound "
            f"{arm_bound_ms(op.plan, *ashape, 1):.4f}), spmm N={ARM_N} "
            f"{arm['spmm_ms']:.4f} ms (bound "
            f"{arm_bound_ms(op.plan, *ashape, ARM_N):.4f}), "
            f"{ARM_N / t_spmm:.1f} requests/s; spmv_last_plan "
            f"{plan.lane_group} lanes a block, {len(plan.windows)} "
            f"window(s), {plan.splits} split(s) (every shard: "
            f"{[plan_record(p) for p in arm['plans']]}); readings "
            + " / ".join(f"{x:.4f}" for x in turns['reads'][f'{key} spmv'])
            + " and "
            + " / ".join(f"{x:.4f}" for x in turns['reads'][f'{key} spmm'])
            + f"  [{card}]")
    best = max(arms, key=lambda key: ARM_N / arms[key]["spmm_ms"])
    swapped = reg.retune(mid)
    now = reg.tune_decision(mid)
    if now.candidate.key != best:
        raise AssertionError(f"retune left the entry on "
                             f"{now.candidate.key}, not the best-measured "
                             f"arm {best}")
    default = arms[TunerCandidate(backend=tuner.backend).key]
    default_spmv = ((default["spmv_ms"], "phase 6's single:1:modulo arm")
                    if scale == 1.0 else (None, None))
    say(f"[phase6] retune: swapped {swapped}, entry on {best}; default "
        f"(single:1:modulo) over auto: spmm "
        f"{default['spmm_ms'] / arms[best]['spmm_ms']:.3f}x, spmv "
        f"{default['spmv_ms'] / arms[best]['spmv_ms']:.3f}x; arms built, "
        f"checked and timed in {time.perf_counter() - t:.1f} s  [{card}]")
    say(json.dumps({"tuner_prior_measured": tuner.to_json()}))
    del arms, fns, op0, xd, xn

    # (c) the 48-request mix through the auto-tuned entry, pipelined.
    t = time.perf_counter()
    svc = SpMVService(reg, max_bucket=ARM_N, retune_every=RETUNE_EVERY,
                      device=dev)
    obs.clear()
    obs.enable()
    zero_launches()
    torch.cuda.synchronize()
    res = serve_pipelined(svc, mid, reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = read_launches()
    by_width = dict(ks.spmm_launches_by_width)
    obs.disable()
    spans = span_seconds()
    for name in ("spmv", "spmm"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"auto-tuned serving path")
    worst = check_results("auto-tuned service vs fp64 reference", res, refs)
    snap = svc.snapshot()
    n_obs = snap["tuner_observations"].get(mid, 0)
    if n_obs != svc.stats.batches or n_obs == 0:
        raise AssertionError(f"{n_obs} observations for "
                             f"{svc.stats.batches} dispatches")
    metrics = obs.REGISTRY.snapshot()
    ratio = obs.REGISTRY.get("tuner_predicted_over_observed_ratio")
    say(f"[phase6] served {len(res)} requests pipelined in {dt:.3f} s "
        f"({len(res) / dt:.1f} req/s, retune_every={RETUNE_EVERY}): "
        f"launches {launches}, spmm launches by width {by_width}, max err "
        f"{worst:.3e}, observations {n_obs}, "
        f"entry now on {reg.tune_decision(mid).candidate.key}")
    say("[phase6] served run's host seconds by span: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(spans.items(),
                                          key=lambda kv: -kv[1])))
    say(f"[phase6] tuner metrics: decisions "
        f"{metrics['tuner_decisions_total']['values']}, retunes "
        f"{metrics['tuner_retunes_total']['values']}, predicted/observed "
        f"ratio count {ratio.count} p50 "
        f"{metrics['tuner_predicted_over_observed_ratio']['p50']}, by "
        f"bucket <= {list(ratio.buckets)} + inf: {ratio.bucket_counts()}")
    # (d) the tuner's state after the served run, printed only.
    say(json.dumps({"tuner_prior": tuner.to_json()}))
    reg.close()
    return launches, by_width, default_spmv


# -- phase 7: the verify gate, cost reports, a traced flush, SparseLinear ---
# The cost report's measured matvec must lie within this factor of phase
# 6's operator-level spmv reading of the same plan.
COST_REPORT_SLACK = 1.5
# SparseLinear at qwen1.5-0.5b's FFN widths, all 24 layers.
FFN_LAYERS, FFN_D, FFN_FF = 24, 1024, 2816
FFN_DENSITY = 0.15
FFN_BATCH = 4


def verify_spans() -> list:
    """(seconds, args) of each traced ``verify`` span."""
    return [(dur_ns / 1e9, args) for buf in obs.TRACER.buffers()
            for ph, name, _, _, dur_ns, args, _ in buf.events
            if ph == "X" and name == "verify"]


def corrupt(plan, rule: str):
    """A copy of ``plan`` with its first shard's stream corrupted in one
    way the verifier names ``rule``: ``seg-monotone`` swaps the first and
    last tiles' seg ids, ``sentinel`` puts a nonzero value in the first
    padding slot, ``round-trip`` flips the column low bit of the first
    live slot (a slip only the full mode's proof against the source can
    see).  The stacked arrays carry the same change; untouched arrays are
    shared with ``plan``."""
    sm = plan.shards[0]
    if rule == "seg-monotone":
        seg = sm.seg_ids.copy()
        seg[[0, -1]] = seg[[-1, 0]]
        new = {"seg_ids": seg}
    elif rule == "sentinel":
        val = sm.val.copy()
        pad = int(np.flatnonzero(sm.idx.reshape(-1) == -1)[0])
        val.reshape(-1)[pad] = 0x3F80 if val.dtype == np.uint16 else 1.0
        new = {"val": val}
    elif rule == "round-trip":
        idx = sm.idx.copy()
        live = int(np.flatnonzero(idx.reshape(-1) != -1)[0])
        idx.reshape(-1)[live] ^= 1
        new = {"idx": idx}
    else:
        raise ValueError(f"no corruption for rule {rule!r}")
    stacked = {}
    for name, arr in new.items():
        st = getattr(plan, name).copy()
        st[0, :arr.shape[0]] = arr
        stacked[name] = st
    return dataclasses.replace(plan, shards=[dataclasses.replace(sm, **new)]
                               + list(plan.shards[1:]), **stacked)


def expect_refusal(plan, rows, cols, vals, mode: str, rule: str) -> str:
    """The registry's gate on a corrupted copy of ``plan`` must raise
    ``VerificationError`` naming ``rule``; returns what it said."""
    bad = corrupt(plan, rule)
    t = time.perf_counter()
    try:
        verify_gate(bad, rows, cols, vals, mode)
    except VerificationError as err:
        hit = [ln for ln in str(err).splitlines() if f"[{rule}]" in ln]
        if not hit:
            raise AssertionError(f"the {rule} control was refused for "
                                 f"another reason: {err}") from err
        return (f"control ({rule}) refused in "
                f"{time.perf_counter() - t:.3f} s: {hit[0].strip()}")
    raise AssertionError(f"the {rule} control passes the {mode} gate")


def traced_gate(what: str, mode: str, run):
    """``run()`` traced: it must pass the registry's verify gate exactly
    once, in ``mode``, with 0 findings.  Returns ``run()``'s result and
    the gate's seconds."""
    obs.clear()
    obs.enable()
    try:
        out = run()
    finally:
        obs.disable()
    spans = verify_spans()
    if [(a["mode"], a["findings"]) for _, a in spans] != [(mode, 0)]:
        raise AssertionError(f"{what}: verify spans {spans}")
    return out, spans[0][0]


def gated_put(reg, what, rows, cols, vals, shape, control: str,
              mode: str = "fast", **kw) -> tuple[str, float]:
    """``reg.put`` through its verify gate in ``mode`` (0 findings), and a
    copy of the installed plan with the ``control`` corruption refused by
    the same gate.  Returns (id, seconds of the put)."""
    t = time.perf_counter()
    mid, secs = traced_gate(what, mode, functools.partial(
        reg.put, rows, cols, vals, shape, verify=mode, **kw))
    put_s = time.perf_counter() - t
    ctl = expect_refusal(reg.get(mid).plan, rows, cols, vals, mode, control)
    say(f"[verify] {what}: put {put_s:.1f} s, verify {mode} {secs:.3f} s, "
        f"0 findings; {ctl}")
    return mid, put_s


def gate_plan(what, plan, rows, cols, vals, mode: str, control: str):
    """The registry's gate on a plan built outside a registry, and its
    ``control`` copy refused."""
    _, secs = traced_gate(what, mode, functools.partial(
        verify_gate, plan, rows, cols, vals, mode))
    ctl = expect_refusal(plan, rows, cols, vals, mode, control)
    say(f"[phase7] verify {mode} on {what} ({plan.idx.size} slots, "
        f"{plan.n_aux} spilled): {secs:.3f} s, 0 findings "
        f"({secs / plan.idx.size * 1e6:.3f} us a slot); {ctl}")


def device_busy_us(events) -> float:
    """Microseconds the card was busy: the union of the trace's kernel,
    memcpy and memset intervals."""
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                for e in events
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -np.inf
    for a, b in iv:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def traced_flush(svc, mid, reqs, refs, card) -> tuple[dict, dict]:
    """Phase 2's 48-request mix in one sync flush: once on the host clock,
    then inside ``profiler_trace``.  The trace must hold the SpMM kernel's
    events and device time; prints the card's busy share of the flush.
    Returns the traced flush's launches and its SpMM launches by width."""
    def submit_all():
        return [svc.submit(mid, x, alpha=a, beta=b, y=y, owner=o)
                for x, a, b, y, o in reqs]

    tickets = submit_all()
    torch.cuda.synchronize()
    t = time.perf_counter()
    svc.flush()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    logdir = os.path.join(ROOT, "build", "traces")
    tickets = submit_all()
    zero_launches()
    torch.cuda.synchronize()
    with profiler_trace(logdir) as prof:
        t = time.perf_counter()
        out = svc.flush()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t
    launches = read_launches()
    by_width = dict(ks.spmm_launches_by_width)
    worst = check_results("traced flush vs fp64 reference",
                          [out[tk] for tk in tickets], refs)
    if launches["spmm"] == 0:
        raise AssertionError(f"the traced flush launched no SpMM: {launches}")
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in device) / 1e3
    if kernel_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time for "
                             "the flush (key_averages)")
    path = max((os.path.join(logdir, f) for f in os.listdir(logdir)),
               key=os.path.getmtime)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spmm = [e for e in events
            if e.get("cat") == "kernel" and "spmm_kernel" in e.get("name", "")]
    # The profiler can drop kernel records (an H100 trace has held 8 for
    # 12 launches), so the events must be there but are not held to the
    # launch count; both counts are printed.
    spmm_avg = sum(e.count for e in device if "spmm_kernel" in e.key)
    if not spmm or not spmm_avg:
        raise AssertionError(f"the trace holds no SpMM kernel events "
                             f"({len(spmm)} in the file, {spmm_avg} in "
                             f"key_averages) for {launches['spmm']} "
                             f"launches")
    busy_ms = device_busy_us(events) / 1e3
    spmm_ms = sum(float(e["dur"]) for e in spmm) / 1e3
    partial = ("" if spmm_avg >= launches["spmm"] else
               " (a lower bound: records were dropped)")
    top = sorted(((e.key, e.self_device_time_total / 1e3) for e in device),
                 key=lambda kv: -kv[1])[:4]
    say(f"[phase7] traced sync flush of {len(reqs)} requests: launches "
        f"{launches}, spmm by width {by_width}, max err {worst:.3e}; "
        f"{len(events)} trace events in {os.path.relpath(path, ROOT)}; card "
        f"busy {busy_ms:.3f} ms (SpMM kernels {spmm_ms:.3f} ms in "
        f"{len(spmm)} events) of the traced flush's {traced_s * 1e3:.3f} ms "
        f"= {busy_ms / (traced_s * 1e3):.4f} busy share{partial}; of the "
        f"untraced flush's {plain_s * 1e3:.3f} ms: "
        f"{busy_ms / (plain_s * 1e3):.4f}; "
        f"SpMM kernel records: {spmm_avg} in key_averages for "
        f"{launches['spmm']} launches; "
        f"top device time: "
        + "; ".join(f"{k[:50]} {v:.3f} ms" for k, v in top) + f"  [{card}]")
    return launches, by_width


def ffn_weights(rng):
    """One layer's seeded FFN weights at qwen1.5-0.5b's widths."""
    scale = 0.02
    return {"w_gate": scale * rng.standard_normal((FFN_FF, FFN_D),
                                                  dtype=np.float32),
            "w_up": scale * rng.standard_normal((FFN_FF, FFN_D),
                                                dtype=np.float32),
            "w_down": scale * rng.standard_normal((FFN_D, FFN_FF),
                                                  dtype=np.float32)}


def ffn_step(layers, x):
    """One decode step's FFN through every layer: RMS-normalised input,
    ``down(silu(gate(h)) * up(h))`` and the residual.  ``x`` is (D,) or
    (B, D).  Returns the output and every projection's (name, input,
    output), for the checks."""
    seen = []
    for i, layer in enumerate(layers):
        h = x / x.pow(2).mean(-1, keepdim=True).add(1e-6).sqrt()
        g = layer["w_gate"](h)
        u = layer["w_up"](h)
        a = torch.nn.functional.silu(g) * u
        d = layer["w_down"](a)
        seen += [(f"{i}.w_gate", h, g), (f"{i}.w_up", h, u),
                 (f"{i}.w_down", a, d)]
        x = x + d
    return x, seen


def check_projection(what, dense, x, y) -> float:
    """A SparseLinear output against the fp32 dense product of the pruned
    weight on the same input, ``|Δ| <= 1e-5·(|W|·|x|) + 1e-6``."""
    if x.dim() == 1:
        return check_close(what, y, torch.mv(dense, x),
                           torch.mv(dense.abs(), x.abs()))
    return check_close(what, y, x @ dense.T, x.abs() @ dense.abs().T)


def linear_bound_ms(sl, n: int) -> float:
    """The operator's stream read once, x read once and y written once
    over the memory rate (2 flops a live slot are far below fp32's)."""
    m, k = sl.shape
    return (sl.op.stream_bytes + 4 * sl.op.plan.seg_ids.size
            + 4 * n * (m + k)) / HBM_BYTES_PER_S * 1e3


def phase_sparse_linear(dev, card) -> tuple[dict, dict]:
    """Phase 7(d): 72 SparseLinear operators of qwen1.5-0.5b's FFN at
    density 0.15, one decode step at batch 1 and at batch 4, each
    projection against the dense pruned product, a control, and the
    timings.  Returns the step's launches and SpMM launches by width."""
    t = time.perf_counter()
    rng = np.random.default_rng(SEED + 7)
    layers, dense, encode_s, nnz = [], [], 0.0, []
    for _ in range(FFN_LAYERS):
        ops_l, dense_l = {}, {}
        for name, w in ffn_weights(rng).items():
            te = time.perf_counter()
            sl = SparseLinear.from_dense(w, density=FFN_DENSITY, device=dev)
            encode_s += time.perf_counter() - te
            ops_l[name] = sl
            dense_l[name] = torch.from_numpy(
                magnitude_prune(w, FFN_DENSITY)).to(dev)
            nnz.append(sl.op.nnz)
        layers.append(ops_l)
        dense.append(dense_l)
    say(f"[phase7] SparseLinear: {len(nnz)} operators of qwen1.5-0.5b's FFN "
        f"({FFN_LAYERS} layers; w_gate, w_up {FFN_FF} x {FFN_D}, w_down "
        f"{FFN_D} x {FFN_FF}) pruned to density {FFN_DENSITY}: nnz "
        f"{min(nnz)}-{max(nnz)}, from_dense (prune + encode + bind) "
        f"{encode_s:.1f} s in all, {encode_s / len(nnz):.3f} s each; phase "
        f"set-up {time.perf_counter() - t:.1f} s")

    gen = torch.Generator(device="cpu").manual_seed(SEED + 8)
    x1 = torch.randn(FFN_D, generator=gen).to(dev)
    x4 = torch.randn((FFN_BATCH, FFN_D), generator=gen).to(dev)
    zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    y1, seen1 = ffn_step(layers, x1)
    y4, seen4 = ffn_step(layers, x4)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    launches = read_launches()
    by_width = dict(ks.spmm_launches_by_width)
    n_proj = 3 * FFN_LAYERS
    if launches["spmv"] != n_proj or launches["spmm"] < n_proj:
        raise AssertionError(f"SparseLinear step launches {launches}: want "
                             f"{n_proj} spmv and >= {n_proj} spmm")
    by_name = {f"{i}.{n}": dense[i][n]
               for i in range(FFN_LAYERS) for n in dense[i]}
    worst = 0.0
    for label, seen in (("batch 1", seen1), (f"batch {FFN_BATCH}", seen4)):
        for name, x, y in seen:
            worst = max(worst, check_projection(
                f"SparseLinear {name} {label} vs dense", by_name[name], x, y))
    for y in (y1, y4):
        if not bool(torch.isfinite(y).all()):
            raise AssertionError("FFN step output is not finite")
    # Control: layer 0's w_gate with the kept weight of the largest
    # |w·h| contribution zeroed must fail the same check.
    name, h, _ = seen1[0]
    wd = by_name[name]
    i, j = divmod(int(torch.argmax((wd * h.abs()).abs())), FFN_D)
    cut = wd.cpu().numpy().copy()
    cut[i, j] = 0.0
    ctl = SparseLinear(cut, device=dev)
    try:
        check_projection("control", wd, h, ctl(h))
    except AssertionError as fail:
        msg = str(fail).split(": ", 1)[1].split(";")[0]
    else:
        raise AssertionError("SparseLinear with a kept weight zeroed "
                             "passes the check")
    say(f"[phase7] SparseLinear decode step (batch 1 and {FFN_BATCH}, "
        f"{FFN_LAYERS} layers): {step_s * 1e3:.1f} ms host clock, launches "
        f"{launches}, spmm by width {by_width}; every projection vs the "
        f"fp32 dense pruned product max err {worst:.3e} (tol 1e-5·|W||x| + "
        f"1e-6); control (layer 0 w_gate, weight ({i}, {j}) zeroed) fails "
        f"as it must ({msg})  [{card}]")

    # Timings: one projection of each shape, in turns with torch.mv/mm on
    # CSR and on the dense pruned weight (yardsticks the port never calls).
    with warnings.catch_warnings():     # torch.sparse's beta notices
        warnings.simplefilter("ignore", UserWarning)
        for name in ("w_up", "w_down"):
            sl, wd = layers[0][name], dense[0][name]
            csr = wd.to_sparse_csr()
            d_in = sl.shape[1]
            h1 = torch.randn(d_in, generator=gen).to(dev)
            h4 = torch.randn((FFN_BATCH, d_in), generator=gen).to(dev)
            p = functools.partial
            for label, x, fns in (
                    ("batch 1 (spmv)", h1,
                     {"kernel": p(sl, h1), "csr": p(torch.mv, csr, h1),
                      "dense": p(torch.mv, wd, h1)}),
                    (f"batch {FFN_BATCH} (SpMM N={FFN_BATCH})", h4,
                     {"kernel": p(sl, h4),
                      "csr": p(torch.mm, csr, h4.T.contiguous()),
                      "dense": p(torch.mm, h4, wd.T)})):
                tm = in_turns(fns, 50)
                n = 1 if x.dim() == 1 else FFN_BATCH
                bd = linear_bound_ms(sl, n)
                reads = ", ".join(f"{k} " + " / ".join(f"{v:.4f}" for v in r)
                                  for k, r in tm["reads"].items())
                say(f"[phase7] SparseLinear {name} {sl.shape[0]} x "
                    f"{sl.shape[1]} ({sl.op.nnz} nnz, {sl.op.padded_slots} "
                    f"slots), {label}: kernel {tm['kernel']:.4f} ms, "
                    f"torch.sparse CSR {tm['csr']:.4f} ms, dense "
                    f"{tm['dense']:.4f} ms; bound {bd:.4f} ms (bytes); "
                    f"readings in turns: {reads}  [{card}]")
    return launches, by_width


def phase_analysis(reg, svc, mid, reqs, refs, opt_src, arm_spmv_ms, dev,
                   card) -> dict:
    """Phase 7: the verify gate (the full-size puts' fast checks, full mode
    at scale 0.1), the G7 cost report, a traced sync flush and
    SparseLinear at full width.  Returns the launches and the SpMM
    launches by width of its two main-path parts."""
    t = time.perf_counter()
    # (a) the verify gate in full mode (each full-size put printed its
    # fast gate's "[verify]" line as it ran).
    r2, c2, v2, shape2, opt_plan = opt_src
    gate_plan("G7 x0.1 OPTIMIZED_CONFIG plan", opt_plan, r2, c2, v2, "full",
              "round-trip")
    breg = MatrixRegistry(device=dev, verify="full")
    gated_put(breg, "G7 x0.1 bf16 put", r2, c2, v2, shape2, "round-trip",
              mode="full", value_dtype="bfloat16")
    say(f"[phase7] (a) verify gate in {time.perf_counter() - t:.1f} s")
    del breg

    # (b) the cost report of the full-size G7 operator.
    t = time.perf_counter()
    op = reg.get(mid)
    rep = op.cost_report(measure=True, iters=20)
    ms = rep["measured_matvec_s"] * 1e3
    ref_ms, ref_what = arm_spmv_ms
    if ref_ms is None:
        xd = torch.from_numpy(reqs[0][0]).to(dev)
        ref_ms = in_turns({"matvec": functools.partial(op.matvec, xd)},
                          20)["matvec"]
        ref_what = "read here: phase 6 measured its arms on a smaller matrix"
    say(f"[phase7] cost report, G7 {rep['partition']}:{rep['num_shards']}:"
        f"{rep['lane_assign']} {rep['value_dtype']}: stream "
        f"{rep['stream_bytes']} B ({rep['bytes_per_slot']} B a slot, "
        f"{rep['bytes_per_nnz']:.4f} B a nonzero), {rep['padded_slots']} "
        f"slots, padding {rep['padding_ratio']:.4f}, lane imbalance "
        f"{rep['lane_slot_imbalance']:.4f}; modeled "
        f"{rep['est_stream_s'] * 1e3:.4f} ms at "
        f"{rep['assumed_bandwidth_gbps']:.0f} GB/s; measured {ms:.4f} ms "
        f"(median of 20, CUDA events), {rep['achieved_gbps']:.1f} GB/s, "
        f"roofline_fraction {rep['roofline_fraction']:.4f}; operator spmv "
        f"{ref_ms:.4f} ms ({ref_what}): {ms / ref_ms:.3f}x  [{card}]")
    if not rep["measured_matvec_s"] >= rep["est_stream_s"]:
        raise AssertionError("the measured matvec beats the modeled stream "
                             "time")
    if not (ms <= COST_REPORT_SLACK * ref_ms
            and ref_ms <= COST_REPORT_SLACK * ms):
        raise AssertionError(f"cost report's {ms} ms is not within "
                             f"{COST_REPORT_SLACK}x of {ref_ms} ms")
    say(f"[phase7] (b) cost report in {time.perf_counter() - t:.1f} s")

    # (c) a traced sync flush; (d) SparseLinear.
    launches, by_width = {}, {}
    launches["flush"], by_width["flush"] = traced_flush(svc, mid, reqs,
                                                        refs, card)
    t = time.perf_counter()
    launches["sparse_linear"], by_width["sparse_linear"] = \
        phase_sparse_linear(dev, card)
    say(f"[phase7] (d) SparseLinear in {time.perf_counter() - t:.1f} s")
    return launches, by_width


# -- phase 8: llama4-scout MoE serving --------------------------------------
MOE_ARCH = "llama4-scout-17b-a16e"
# 12 of the 48 layers: each layer holds 4.15 GB in bf16 (its 16 experts
# 4.03 GB) and the embedding and untied head 4.14 GB, so 48 layers
# (203.5 GB) do not fit one 80 GB card; 12 take 53.97 GB.  The width is
# the published one.
MOE_LAYERS = 12
MOE_BATCH, MOE_PROMPT, MOE_DECODE = 4, 2000, 16
# The flash kernel at the served prefill's shape (FLASH_CASES' layout).
LLAMA4_FLASH = ("llama4 heads", MOE_BATCH, MOE_PROMPT, 8, 5, 128, 128,
                True, torch.bfloat16)
# Phase 8(d): layer 0's MoE on the card in bf16 against the same function
# on the CPU in fp32, on MOE_CHECK_TOKENS of the prompt's hidden states
# and the same bf16 weights: ||Δ|| <= MOE_LAYER_REL·||cpu||, about 5x the
# first H100 reading (3.921e-3: the bf16 run rounds g, u, act(g)·u and
# the output, 2^-9 each).  A swap of two experts that received tokens
# gives their tokens another expert's output and must fail (it read 0.585).
MOE_CHECK_TOKENS = 64
MOE_LAYER_REL = 2e-2


def first_input(fn, seen: list):
    """``fn`` that keeps a copy of the input (its second argument) of its
    first call in ``seen``."""
    def rec(p, x, *args, **kwargs):
        if not seen:
            seen.append(x.detach().clone())
        return fn(p, x, *args, **kwargs)
    return rec


def host_syncs(fn) -> list:
    """The host syncs of one call of ``fn``, as ``torch.cuda``'s sync
    debug mode reports them (one warning per synchronising call) while
    ``fn`` runs: where each came from, the innermost Python frame and,
    when that lies outside the repository, the innermost frame inside it.
    (Switching the mode on warns once per process by itself.)"""
    seen, running = [], []

    def where(f):
        return f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"

    def record(message, category, filename, lineno, file=None, line=None):
        if not running or "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if f.filename != warnings.__file__]
        ours = [f for f in stack if f.filename.startswith(ROOT)]
        got = where(stack[-1])
        if ours and ours[-1] is not stack[-1]:
            got += f" (from {where(ours[-1])})"
        seen.append(got)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        running.append(True)
        try:
            fn()
        finally:
            running.clear()
            torch.cuda.set_sync_debug_mode("default")
    return seen


def phase_moe(dev, card):
    """Phase 8; returns (launches, max error, per-body flash record at the
    llama4 shape)."""
    # (a) the flash kernel at the served prefill's shape.
    t = time.perf_counter()
    err, inputs = check_flash_case(LLAMA4_FLASH, dev, "phase8")
    del inputs
    _, b, s, kvh, g, dh, dv, causal, _ = LLAMA4_FLASH
    tm = time_flash(b, s, kvh, g, dh, causal, dev, (20, 3))
    bd, by = flash_bound(b, s, kvh, g, dh, dv, causal)
    bytes_ms = 2 * b * s * kvh * (g * dh + dh + dv + g * dv) \
        / HBM_BYTES_PER_S * 1e3
    reads = ", ".join(f"{n} " + " / ".join(f"{x:.4f}" for x in r)
                      for n, r in tm["reads"].items())
    wg, mma, lib = tm["wgmma"], tm["mma"], tm["library"]
    say(f"[phase8] flash llama4 heads (B={b}, S={s}, KV={kvh}, G={g}, "
        f"dh={dh}, bf16, causal): wgmma body {wg:.4f} ms ({bd / wg:.3f} of "
        f"the bound), mma body {mma:.4f} ms, scaled_dot_product_attention "
        f"{lib:.4f} ms (the wgmma body at {lib / wg:.2f}x its speed), "
        f"plain {tm['plain']:.4f} ms; bound {bd:.4f} ms ({by}; the "
        f"bytes alone {bytes_ms:.4f} ms); readings in turns: {reads}  "
        f"[{card}]")
    bodies = {body: {"llama4": {"ms": tm[body], "bound_ms": bd,
                                "library_ms": lib}}
              for body in ("wgmma", "mma")}
    say(f"[phase8] (a) in {time.perf_counter() - t:.1f} s")

    # (b) serve llama4-scout at full width, MOE_LAYERS deep.
    t = time.perf_counter()
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    resident = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    say(f"[phase8] {MOE_ARCH}: {cfg.num_layers} of its {full.num_layers} "
        f"layers (the one cut: 48 do not fit one card), d={cfg.d_model}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV of "
        f"{cfg.head_dim}, {cfg.moe.num_experts} experts of d_ff "
        f"{cfg.d_ff}, top-{cfg.moe.top_k}, vocab {cfg.vocab_padded}; "
        f"{resident / 1e9:.2f} GB of weights made on the card in "
        f"{time.perf_counter() - t:.1f} s; router "
        f"{params['blocks'][0]['sub0']['ffn']['router'].dtype}")
    max_len = MOE_PROMPT + MOE_DECODE + 1
    eng = ServeEngine(lm, params, max_len=max_len)
    rng = np.random.default_rng(SEED + 8)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT))).to(dev)
    batch = {"inputs": prompts}
    eng.generate({"inputs": prompts[:, :64]}, 2)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = eng.generate(batch, MOE_DECODE + 1)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    launches = read_launches()
    by_body = dict(fa.flash_launches_by_body)
    peak = torch.cuda.max_memory_allocated()
    if launches["flash_attention"] != cfg.num_layers or \
            by_body["wgmma"] != cfg.num_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times in the "
                             f"serve ({by_body}), not the wgmma body once "
                             f"per layer ({cfg.num_layers})")
    if tuple(out.shape) != (MOE_BATCH, MOE_DECODE + 1) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of "
                             f"range [{int(out.min())}, {int(out.max())}]")
    for name in bodies:
        bodies[name]["launches"] = by_body[name]

    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = eng.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        raise AssertionError("non-finite prefill logits")
    tok = out[:, :1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(MOE_DECODE):
        _, cache = eng.decode_step(cache, tok, MOE_PROMPT + i)
        tok = out[:, i + 1:i + 2]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / MOE_DECODE
    del logits, cache
    head = cfg.d_model * cfg.vocab_padded
    say(f"[phase8] serve {MOE_BATCH} x {MOE_PROMPT} tokens + {MOE_DECODE} "
        f"greedy decode steps: generate {gen_s:.3f} s, launches {launches},"
        f" flash by body {by_body}; prefill {prefill_ms:.2f} ms "
        f"({MOE_BATCH * MOE_PROMPT / prefill_ms:.1f} tokens/ms), decode "
        f"{decode_ms:.3f} ms per step ({MOE_BATCH * 1e3 / decode_ms:.1f} "
        f"tokens/s); peak memory {peak / 1e9:.2f} GB "
        f"(max_memory_allocated)  [{card}]")
    say(f"[phase8] each prefill and decode step copies lm_head to fp32 "
        f"(_lm_logits_chunk): {4 * head / 1e9:.2f} GB made, "
        f"{(2 + 4 + 4) * head / 1e9:.2f} GB moved against "
        f"{2 * head / 1e9:.2f} GB for a bf16 product, "
        f"{8 * head / HBM_BYTES_PER_S * 1e3:.3f} ms of extra traffic at "
        f"3.35 TB/s")
    say(f"[phase8] request 0's tokens: {out[0].tolist()}")
    profile_serve(eng, batch, out, card,
                  {"prefill": prefill_ms, "decode": decode_ms}, tag="phase8")

    # One MoE layer alone: host syncs, and its ms at prefill and decode
    # size (x MOE_LAYERS, its share of the served step).  Each call waits
    # for its group sizes, so its CUDA-event time is its host time.
    ffn0 = params["blocks"][0]["sub0"]["ffn"]
    seen = []

    # (c) the same prefill with the plain attention in the kernel's place;
    # the kernel run also keeps layer 0's MoE input.
    with patched(moe, "moe_apply", first_input(moe.moe_apply, seen)):
        k_logits, _ = eng.prefill(batch)
    with patched(fa, "flash_attention", fa.flash_attention_plain):
        p_logits, _ = eng.prefill(batch)
    h0 = seen[0]
    real = slice(0, cfg.vocab_size)
    d_logits = float((k_logits[:, real] - p_logits[:, real]).abs().max())
    top2 = p_logits[:, real].topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    k_tok = k_logits[:, real].argmax(-1).tolist()
    p_tok = p_logits[:, real].argmax(-1).tolist()
    # |Δ| <= d elementwise can move the argmax only where the plain
    # logits' top two lie within 2d: every other prompt must agree.
    held = [i for i, gp in enumerate(gaps) if gp > 2 * d_logits]
    say(f"[phase8] bf16 prefill vs the same with plain attention: "
        f"last-position logits max |Δ| {d_logits:.4e} (tol "
        f"{LM_BF16_LOGIT_TOL}); first tokens kernel {k_tok}, plain "
        f"{p_tok}; plain top-1/top-2 gaps "
        + ", ".join(f"{gp:.4f}" for gp in gaps)
        + f"; held to equal: prompts {held}")
    if not d_logits <= LM_BF16_LOGIT_TOL:
        raise AssertionError(f"bf16 llama4 prefill with the kernel differs "
                             f"from plain: logits {d_logits}")
    if any(k_tok[i] != p_tok[i] for i in held):
        raise AssertionError(f"greedy first tokens differ where the logits "
                             f"bound holds them equal: {k_tok} vs {p_tok}")
    del k_logits, p_logits

    d = cfg.d_model
    counts = torch.bincount(moe._route(ffn0, h0.reshape(-1, d), cfg)[0]
                            .reshape(-1), minlength=cfg.moe.num_experts)
    x_dec = h0[:, -1:].contiguous()
    syncs = {"prefill": host_syncs(lambda: moe.moe_apply(
        ffn0, h0, cfg, exact=True)), "decode": host_syncs(
        lambda: moe.moe_apply(ffn0, x_dec, cfg, exact=True, decode=True))}
    moe_ms = {"prefill": time_ms(lambda: moe.moe_apply(
        ffn0, h0, cfg, exact=True), 5), "decode": time_ms(
        lambda: moe.moe_apply(ffn0, x_dec, cfg, exact=True,
                              decode=True), 20)}
    step = {"prefill": prefill_ms, "decode": decode_ms}
    say(f"[phase8] layer 0 at prefill: tokens per expert "
        f"{counts.tolist()}; host syncs of one MoE layer: prefill "
        f"{len(syncs['prefill'])} {syncs['prefill']}, decode "
        f"{len(syncs['decode'])} {syncs['decode']}; one MoE layer "
        + ", ".join(f"{k} {moe_ms[k]:.3f} ms (x{cfg.num_layers}: "
                    f"{moe_ms[k] * cfg.num_layers / step[k]:.2f} of the "
                    f"served {k})" for k in moe_ms)
        + f"  [{card}]")
    if not syncs["prefill"]:
        raise AssertionError("the sync debug mode saw no sync in the MoE "
                             "dispatch, which reads its group sizes")

    # (d) layer 0's MoE on the card (bf16) against the CPU (fp32), on
    # MOE_CHECK_TOKENS of its prefill inputs spread over the prompts.
    t = time.perf_counter()
    flat = h0.reshape(-1, d)
    xs = flat[torch.linspace(0, flat.shape[0] - 1, MOE_CHECK_TOKENS,
                             device=dev).long()][None]
    got, _ = moe.moe_apply(ffn0, xs, cfg, exact=True)
    cpu = {k: v.cpu().float() for k, v in ffn0.items()}
    x_cpu = xs.cpu().float()
    want, _ = moe.moe_apply(cpu, x_cpu, cfg, exact=True)
    gi = moe._route(ffn0, xs[0], cfg)[0].cpu()
    wi = moe._route(cpu, x_cpu[0], cfg)[0]
    lg = x_cpu[0].double() @ cpu["router"].double()
    top = lg.topk(2, dim=-1).values
    gap = float((top[:, 0] - top[:, 1]).min())
    if not torch.equal(gi, wi):
        raise AssertionError(f"card and CPU route layer 0's tokens apart "
                             f"(smallest top-1/top-2 logit gap {gap:.3e})")
    r = rel_err(got.cpu(), want)
    used = torch.unique(wi).tolist()
    a, c = used[0], used[-1]
    swapped = dict(cpu)
    for name in ("w_gate", "w_up", "w_down"):
        w = cpu[name].clone()
        w[[a, c]] = w[[c, a]]
        swapped[name] = w
    ctl, _ = moe.moe_apply(swapped, x_cpu, cfg, exact=True)
    r_ctl = rel_err(got.cpu(), ctl)
    say(f"[phase8] layer 0's MoE on {MOE_CHECK_TOKENS} prefill tokens, "
        f"card bf16 vs CPU fp32: routing equal (smallest top-1/top-2 "
        f"logit gap {gap:.3e}), ||Δ||/||cpu|| {r:.3e} (tol "
        f"{MOE_LAYER_REL}); control (experts {a} and {c} swapped): {r_ctl:.3e}"
        f"; in {time.perf_counter() - t:.1f} s")
    if not r <= MOE_LAYER_REL:
        raise AssertionError(f"the card's MoE layer differs from the CPU's: "
                             f"{r}")
    if not r_ctl > MOE_LAYER_REL:
        raise AssertionError(f"a MoE layer with experts {a} and {c} "
                             f"swapped passes the check ({r_ctl})")
    del params, eng, ffn0, cpu, swapped, h0, seen
    return launches, err, bodies


# -- phase 9: mamba2-1.3b SSM serving ----------------------------------------
SSM_ARCH = "mamba2-1.3b"
SSM_BATCH, SSM_PROMPT, SSM_DECODE = 4, 2000, 16
# Phase 9(b): a prefill of SSM_HANDOFF tokens, then one decode step, so
# the P + 1 tokens of the prefill it is held against cross the chunk
# boundary at 256.  In fp32 (a copy of the served bf16 weights) the
# decode's logits must lie within SSM_HANDOFF_TOL of that prefill's last
# position: about 10x the 1.2e-5 a 48-layer CPU model of d 256 gave (a
# chunked sum against the recurrence, in fp32).  Zeroing the cache's h
# (the control) gave 0.19 there and must fail.
SSM_HANDOFF = 256
SSM_HANDOFF_TOL = 2e-4
# Phase 9(c): layer 0's mixer on SSM_CHECK_TOKENS of each prompt's
# hidden states (one full chunk and a padded second), on the card in
# bf16 against the same function on the CPU in fp32 with the same bf16
# weights, ||Δ|| <= SSM_LAYER_REL·||cpu|| (a CPU bf16 run read 6.1e-3);
# its control reverses conv_x's taps.  The card's fp32 run of the same
# layer must lie within SSM_LAYER_FP32_REL of the CPU's: this is the
# check that can see a dropped inter-chunk carry (the control), which
# moves the layer's output by 1.2e-3 in norm at this init (every head
# forgets within a few steps), below bf16's rounding.
SSM_CHECK_TOKENS = 300
SSM_LAYER_REL = 2e-2
SSM_LAYER_FP32_REL = 1e-4
# Phase 9(a): the served run's peak allocation above what was allocated
# before it.  Predicted about 1.3 GB: the 48 layers' decode state (0.40
# GB) held twice while prefill stacks it, one layer's prefill temporaries
# (fp32 copies of x and y, 0.13 GB each, and a chunk's 67 MB decay and
# score tensors) and the fp32 copy of the tied embedding (0.41 GB) the
# logits read.  Conv tails that keep their (B, S, C) projections alive
# (the control) add 48 x 69.6 MB = 3.3 GB and must fail.
SSM_PEAK_OVER = 2.5e9


def dropped_carry(fn):
    """``_ssd_chunk`` that starts every chunk from a zero state: the scan
    without its inter-chunk carry (``y_inter`` and the carried h)."""
    def run(h, inp, rep):
        return fn(torch.zeros_like(h), inp, rep)
    return run


def viewed_tails(projections, cfg):
    """``_conv_tail`` returning views that keep each layer's whole
    (B, S, C) projections alive: phase 9(a)'s memory control."""
    return tuple(t[:, -(cfg.ssm.conv_width - 1):] for t in projections)


def phase_ssm(dev, card, t_run):
    """Phase 9; returns the kernels' launches in its serve (all 0)."""
    if time.perf_counter() - t_run > SLOW_RUN_S:
        say(f"[phase9] the run has passed {SLOW_RUN_S:.0f} s "
            f"({time.perf_counter() - t_run:.1f} s); phase 9 runs in full")
    # (a) serve mamba2-1.3b at its published width and depth.
    t = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    resident = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    s = cfg.ssm
    mixer0 = params["blocks"][0]["sub0"]["mixer"]
    say(f"[phase9] {SSM_ARCH}: {cfg.num_layers} layers of "
        f"{cfg.layout[0]}, d={cfg.d_model}, SSD {ssm._heads_of(cfg)} heads "
        f"of {s.head_dim}, d_state {s.d_state}, {s.n_groups} group, chunk "
        f"{s.chunk_size}, conv {s.conv_width}, vocab {cfg.vocab_padded} "
        f"(tied); {resident / 1e9:.3f} GB of weights made on the card in "
        f"{time.perf_counter() - t:.1f} s; a_log "
        f"{mixer0['a_log'].dtype}, wx {mixer0['wx'].dtype}")
    max_len = SSM_PROMPT + SSM_DECODE + 1
    eng = ServeEngine(lm, params, max_len=max_len)
    rng = np.random.default_rng(SEED + 9)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT))).to(dev)
    batch = {"inputs": prompts}
    eng.generate({"inputs": prompts[:, :64]}, 2)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = eng.generate(batch, SSM_DECODE + 1)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        raise AssertionError(f"mamba2 has no attention, yet its serve "
                             f"launched {launches}")
    torch.cuda.reset_peak_memory_stats()
    with patched(ssm, "_conv_tail", viewed_tails):
        eng.prefill(batch)
    torch.cuda.synchronize()
    ctl_over = torch.cuda.max_memory_allocated() - base
    if tuple(out.shape) != (SSM_BATCH, SSM_DECODE + 1) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of "
                             f"range [{int(out.min())}, {int(out.max())}]")

    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = eng.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        raise AssertionError("non-finite prefill logits")
    state = {name: tuple(x.shape) for name, x in cache["sub0"].items()}
    state_bytes = sum(x.numel() * x.element_size()
                      for x in cache["sub0"].values())
    tok = out[:, :1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(SSM_DECODE):
        _, cache = eng.decode_step(cache, tok, SSM_PROMPT + i)
        tok = out[:, i + 1:i + 2]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / SSM_DECODE
    del logits, cache
    say(f"[phase9] serve {SSM_BATCH} x {SSM_PROMPT} tokens + {SSM_DECODE} "
        f"greedy decode steps: generate {gen_s:.3f} s, launches {launches};"
        f" prefill {prefill_ms:.2f} ms ({SSM_BATCH * SSM_PROMPT / prefill_ms:.1f}"
        f" tokens/ms), decode {decode_ms:.3f} ms per step "
        f"({SSM_BATCH * 1e3 / decode_ms:.1f} tokens/s); decode state "
        f"{state} ({state_bytes / 1e9:.3f} GB, no sequence axis); peak "
        f"memory {peak / 1e9:.3f} GB (max_memory_allocated), "
        f"{(peak - base) / 1e9:.3f} GB over the {base / 1e9:.3f} GB held "
        f"before the serve (bound {SSM_PEAK_OVER / 1e9}); control (conv "
        f"tails kept as views, prefill alone): {ctl_over / 1e9:.3f} GB over"
        f"  [{card}]")
    if not peak - base <= SSM_PEAK_OVER:
        raise AssertionError(f"the serve allocated {peak - base} bytes over "
                             f"what it started with")
    if not ctl_over > SSM_PEAK_OVER:
        raise AssertionError(f"conv tails kept as views pass the memory "
                             f"bound ({ctl_over})")
    say(f"[phase9] request 0's tokens: {out[0].tolist()}")
    profile_serve(eng, batch, out, card,
                  {"prefill": prefill_ms, "decode": decode_ms}, tag="phase9")

    # Layer 0's input, kept from a served prefill, for (c) and (d).
    seen = []
    with patched(ssm, "ssm_forward", first_input(ssm.ssm_forward, seen)):
        eng.prefill(batch)
    h0 = seen[0]

    # (d) one mamba layer alone: ms at prefill and decode size (x48:
    # its share of the served step) and its host syncs.  Before (b) and
    # (c), whose CPU runs leave torch's CPU threads spinning beside the
    # host-bound decode.
    one = {k: v[0].clone() for k, v in lm.init_cache(
        SSM_BATCH, 1, device=dev)["sub0"].items()}
    x_dec = h0[:, -1:].contiguous()
    calls = {"prefill": lambda: ssm.ssm_forward(mixer0, h0, cfg,
                                                return_state=True),
             "decode": lambda: ssm.ssm_decode(mixer0, x_dec, cfg, one)}
    syncs = {k: host_syncs(fn) for k, fn in calls.items()}
    layer_ms = {"prefill": time_ms(calls["prefill"], 5),
                "decode": time_ms(calls["decode"], 20)}
    step = {"prefill": prefill_ms, "decode": decode_ms}
    say(f"[phase9] one mamba layer (CUDA events): "
        + ", ".join(f"{k} {layer_ms[k]:.3f} ms (x{cfg.num_layers}: "
                    f"{layer_ms[k] * cfg.num_layers / step[k]:.2f} of the "
                    f"served {k})" for k in layer_ms)
        + f"; host syncs: prefill {len(syncs['prefill'])} "
        f"{syncs['prefill']}, decode {len(syncs['decode'])} "
        f"{syncs['decode']}  [{card}]")
    if syncs["prefill"] or syncs["decode"]:
        raise AssertionError(f"a mamba layer synchronises the host: {syncs}")
    del one

    # (b) the state handoff: decode token P+1 after a prefill of P, against
    # the last position of a prefill of P+1 (crossing the chunk boundary).
    t = time.perf_counter()
    p = SSM_HANDOFF
    nxt = prompts[:, p:p + 1]

    def handoff(model, weights, control=False):
        ref, _ = model.prefill(weights, {"inputs": prompts[:, :p + 1]}, p + 2)
        _, c = model.prefill(weights, {"inputs": prompts[:, :p]}, p + 2)
        if control:
            c["sub0"]["h"].zero_()
        got, _ = model.decode_step(weights, c, nxt, p)
        real = slice(0, cfg.vocab_size)
        return got[:, real], ref[:, real]

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    lm32 = LM(cfg32)
    params32 = tree_map(lambda x: x.float(), params)
    got, ref = handoff(lm32, params32)
    d32 = float((got - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    held = [i for i, gp in enumerate(gaps) if gp > 2 * d32]
    d_tok, r_tok = got.argmax(-1).tolist(), ref.argmax(-1).tolist()
    ctl = float(torch.sub(*handoff(lm32, params32, control=True))
                .abs().max())
    bg, br = handoff(lm, params)
    d16 = float((bg - br).abs().max())
    say(f"[phase9] state handoff, fp32 copy of the weights: decode of token "
        f"{p + 1} after a {p}-token prefill vs the {p + 1}-token prefill's "
        f"last position: logits max |Δ| {d32:.4e} (tol {SSM_HANDOFF_TOL}); "
        f"first tokens decode {d_tok}, prefill {r_tok}, prefill top-1/top-2 "
        f"gaps " + ", ".join(f"{gp:.4f}" for gp in gaps) + f", held to "
        f"equal: prompts {held}; control (cache h zeroed): {ctl:.4e}; the "
        f"served bf16 weights read {d16:.4e} (a reading, no bound); in "
        f"{time.perf_counter() - t:.1f} s  [{card}]")
    if not d32 <= SSM_HANDOFF_TOL:
        raise AssertionError(f"decode after prefill differs from the longer "
                             f"prefill: {d32}")
    if any(d_tok[i] != r_tok[i] for i in held):
        raise AssertionError(f"first tokens differ where the bound holds "
                             f"them equal: {d_tok} vs {r_tok}")
    if not ctl > SSM_HANDOFF_TOL:
        raise AssertionError(f"a decode from a zeroed state passes the "
                             f"handoff check ({ctl})")
    del bg, br, got, ref

    # (c) layer 0's mixer at full width: the card (bf16, and fp32 from the
    # same weights) against the CPU in fp32.
    t = time.perf_counter()
    xs = h0[:, :SSM_CHECK_TOKENS]
    got = ssm.ssm_forward(mixer0, xs, cfg)
    got32 = ssm.ssm_forward(params32["blocks"][0]["sub0"]["mixer"],
                            xs.float(), cfg32)
    cpu = {k: v.cpu().float() for k, v in mixer0.items()}
    x_cpu = xs.cpu().float()
    want = ssm.ssm_forward(cpu, x_cpu, cfg32)
    with patched(ssm, "_ssd_chunk", dropped_carry(ssm._ssd_chunk)):
        ctl_carry = ssm.ssm_forward(cpu, x_cpu, cfg32)
    flipped = dict(cpu, conv_x=cpu["conv_x"].flip(0))
    ctl_conv = ssm.ssm_forward(flipped, x_cpu, cfg32)
    r, r32 = rel_err(got.cpu(), want), rel_err(got32.cpu(), want)
    rc = {name: (rel_err(got.cpu(), c), rel_err(got32.cpu(), c))
          for name, c in (("carry dropped", ctl_carry),
                          ("conv_x taps reversed", ctl_conv))}
    say(f"[phase9] layer 0's mixer on {SSM_BATCH} x {SSM_CHECK_TOKENS} "
        f"prefill tokens vs CPU fp32: card bf16 ||Δ||/||cpu|| {r:.3e} (tol "
        f"{SSM_LAYER_REL}), card fp32 {r32:.3e} (tol {SSM_LAYER_FP32_REL}); "
        f"controls (bf16, fp32): " + "; ".join(
            f"{n} {a:.3e}, {b:.3e}" for n, (a, b) in rc.items())
        + f"; in {time.perf_counter() - t:.1f} s  [{card}]")
    if not (r <= SSM_LAYER_REL and r32 <= SSM_LAYER_FP32_REL):
        raise AssertionError(f"the card's mamba layer differs from the "
                             f"CPU's: bf16 {r}, fp32 {r32}")
    if not rc["carry dropped"][1] > SSM_LAYER_FP32_REL:
        raise AssertionError(f"a scan without its inter-chunk carry passes "
                             f"the fp32 check ({rc['carry dropped'][1]})")
    if not rc["conv_x taps reversed"][0] > SSM_LAYER_REL:
        raise AssertionError(f"reversed conv taps pass the bf16 check "
                             f"({rc['conv_x taps reversed'][0]})")
    del params32, lm32, got32, cpu, flipped, want, ctl_carry, ctl_conv

    del params, eng, mixer0, h0, seen
    return launches


# -- phase 10: minicpm3-4b MLA serving -------------------------------------
MLA_ARCH = "minicpm3-4b"
MLA_BATCH, MLA_PROMPT, MLA_DECODE = 4, 2000, 16
# The flash kernel at the served prefill's shape: q (4, 2000, 40, 1, 96),
# v (..., 64), bf16, causal; phase 5(a) checks it and its control.
MLA_FLASH = next(c for c in FLASH_CASES if c[0] == "minicpm3 MLA heads")
# Phase 10(b): layer 0's MLA mixer on MLA_CHECK_TOKENS of each prompt's
# hidden states, on the card in bf16 against the same function on the CPU
# in fp32 from the same bf16 weights: ||Δ|| <= MLA_LAYER_REL·||cpu|| (the
# same layer in bf16 on the CPU read 5.8e-3 on 2 x 320 random tokens).
# Two controls must fail it: the query heads split as [nope, rope] and
# the expansion without kv_norm (on the CPU they read 0.87 and 0.21).
MLA_CHECK_TOKENS = 320
MLA_LAYER_REL = 2e-2
# Phase 10(c): decode of token MLA_HANDOFF + 1 after a prefill of
# MLA_HANDOFF tokens, in fp32 (a copy of the served bf16 weights), held
# against the last position of the MLA_HANDOFF + 1 prefill: logits
# within MLA_HANDOFF_TOL, about 100x the 2.4e-6 a 6-layer CPU model of
# the published width read (the card's fp32 flash body against the
# decode's torch ops, through 62 layers).  The decode with the cache's
# krope zeroed (it read 0.43 there) must fail it.
MLA_HANDOFF = 300
MLA_HANDOFF_TOL = 2e-4


def nope_first(mixer, cfg):
    """MLA weights on which the port computes what a port that splits
    each query head as ``[nope, rope]`` (DeepSeek-V2's published order)
    would compute on ``mixer``: each head's ``wq_b`` columns rotated by
    ``nope_head_dim``, so the slice the port rotates and pairs with
    ``k_rope`` is the head's last ``rope_head_dim`` columns."""
    c = cfg.mla
    w = mixer["wq_b"].reshape(c.q_lora_rank, cfg.num_heads, -1)
    w = torch.cat([w[..., c.nope_head_dim:], w[..., :c.nope_head_dim]], -1)
    return dict(mixer, wq_b=w.reshape(c.q_lora_rank, -1))


def without_kv_norm(mixer):
    """``models.attention.rms_norm`` that returns unchanged the latent it
    would normalise with ``mixer``'s ``kv_norm``: patched in, the MLA
    expansion runs without its norm."""
    norm = attn.rms_norm

    def run(x, scale, eps=1e-5):
        return x if scale is mixer["kv_norm"] else norm(x, scale, eps)
    return run


def phase_mla(dev, card, t_run):
    """Phase 10; returns (launches, max error, per-body flash record at
    MLA's shape)."""
    if time.perf_counter() - t_run > SLOW_RUN_S:
        say(f"[phase10] the run has passed {SLOW_RUN_S:.0f} s "
            f"({time.perf_counter() - t_run:.1f} s); phase 10 runs in full"
            f"  [{card}]")
    # The wgmma body, and the mma body on an offset copy, at the served
    # prefill's shape, timed in turns with scaled_dot_product_attention
    # (phase 5(a) checked both against plain).
    t = time.perf_counter()
    _, b, s, kvh, g, dh, dv, causal, _ = MLA_FLASH
    tm = time_flash(b, s, kvh, g, dh, causal, dev, (20, 3), dv=dv)
    bd, by = flash_bound(b, s, kvh, g, dh, dv, causal)
    bytes_ms = 2 * b * s * kvh * (g * dh + dh + dv + g * dv) \
        / HBM_BYTES_PER_S * 1e3
    reads = ", ".join(f"{n} " + " / ".join(f"{x:.4f}" for x in r)
                      for n, r in tm["reads"].items())
    wg, mma, lib = tm["wgmma"], tm["mma"], tm["library"]
    say(f"[phase10] flash minicpm3 MLA heads (B={b}, S={s}, H={kvh}, "
        f"dh={dh}, dv={dv}, bf16, causal): wgmma body {wg:.4f} ms "
        f"({bd / wg:.3f} of the bound), mma body {mma:.4f} ms "
        f"({bd / mma:.3f}; wgmma at {mma / wg:.2f}x its speed), "
        f"scaled_dot_product_attention {lib:.4f} ms (the wgmma body at "
        f"{lib / wg:.2f}x its speed), plain {tm['plain']:.4f} ms; bound "
        f"{bd:.4f} ms ({by}; the bytes alone {bytes_ms:.4f} ms); readings "
        f"in turns: {reads}  [{card}]")
    bodies = {body: {"minicpm3": {"ms": tm[body], "bound_ms": bd,
                                  "plain_ms": tm["plain"],
                                  "library_ms": lib}}
              for body in ("wgmma", "mma")}
    say(f"[phase10] flash timings in {time.perf_counter() - t:.1f} s  "
        f"[{card}]")

    # (a) serve minicpm3-4b at its published width and depth.
    t = time.perf_counter()
    cfg = get_config(MLA_ARCH)
    c = cfg.mla
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    resident = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    mixer0 = params["blocks"][0]["sub0"]["mixer"]
    say(f"[phase10] {MLA_ARCH}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{cfg.num_heads} heads, MLA q_lora {c.q_lora_rank}, kv_lora "
        f"{c.kv_lora_rank}, rope {c.rope_head_dim} + nope {c.nope_head_dim}"
        f", v {c.v_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded} "
        f"(untied); {resident / 1e9:.3f} GB of weights made on the card in "
        f"{time.perf_counter() - t:.1f} s; nothing cut  [{card}]")
    max_len = MLA_PROMPT + MLA_DECODE + 1
    eng = ServeEngine(lm, params, max_len=max_len)
    rng = np.random.default_rng(SEED + 10)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MLA_BATCH, MLA_PROMPT + 1))).to(dev)
    batch = {"inputs": prompts[:, :MLA_PROMPT]}
    eng.generate({"inputs": prompts[:, :64]}, 2)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = eng.generate(batch, MLA_DECODE + 1)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    launches = read_launches()
    by_body = dict(fa.flash_launches_by_body)
    peak = torch.cuda.max_memory_allocated()
    want_bodies = {name: cfg.num_layers if name == "wgmma" else 0
                   for name in by_body}
    if launches["flash_attention"] != cfg.num_layers or \
            by_body != want_bodies:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times in the "
                             f"serve ({by_body}), not the wgmma body once "
                             f"per layer ({cfg.num_layers}) and no other")
    if tuple(out.shape) != (MLA_BATCH, MLA_DECODE + 1) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of "
                             f"range [{int(out.min())}, {int(out.max())}]")
    for name in bodies:
        bodies[name]["launches"] = by_body[name]

    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = eng.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        raise AssertionError("non-finite prefill logits")
    latent = {name: tuple(x.shape) for name, x in cache["sub0"].items()}
    latent_bytes = sum(x.numel() * x.element_size()
                       for x in cache["sub0"].values())
    full_kv = (2 * cfg.num_layers * MLA_BATCH * max_len * cfg.num_heads
               * (c.rope_head_dim + c.nope_head_dim + c.v_head_dim))
    tok = out[:, :1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(MLA_DECODE):
        _, cache = eng.decode_step(cache, tok, MLA_PROMPT + i)
        tok = out[:, i + 1:i + 2]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / MLA_DECODE
    del logits, cache
    say(f"[phase10] serve {MLA_BATCH} x {MLA_PROMPT} tokens + {MLA_DECODE} "
        f"greedy decode steps: generate {gen_s:.3f} s, launches {launches},"
        f" flash by body {by_body}; prefill {prefill_ms:.2f} ms "
        f"({MLA_BATCH * MLA_PROMPT / prefill_ms:.1f} tokens/ms), decode "
        f"{decode_ms:.3f} ms per step ({MLA_BATCH * 1e3 / decode_ms:.1f} "
        f"tokens/s); latent cache {latent} = {latent_bytes / 1e9:.3f} GB "
        f"against {full_kv / 1e9:.3f} GB for a full K/V cache of "
        f"{cfg.num_heads} x ({c.rope_head_dim + c.nope_head_dim} + "
        f"{c.v_head_dim}) ({full_kv / latent_bytes:.1f}x); peak memory "
        f"{peak / 1e9:.3f} GB (max_memory_allocated), "
        f"{(peak - base) / 1e9:.3f} GB over the {base / 1e9:.3f} GB held "
        f"before the serve  [{card}]")
    say(f"[phase10] request 0's tokens: {out[0].tolist()}")
    profile_serve(eng, batch, out, card,
                  {"prefill": prefill_ms, "decode": decode_ms},
                  tag="phase10")

    # Layer 0's input, kept from a served prefill, for (b) and (d).
    seen = []
    with patched(attn, "mla_forward", first_input(attn.mla_forward, seen)):
        eng.prefill(batch)
    h0 = seen[0]

    # (d) one MLA layer alone: ms at prefill and decode size (x62: its
    # share of the served step) and its host syncs.  Before (b) and (c),
    # whose CPU runs leave torch's CPU threads spinning.
    one = lm.init_cache(MLA_BATCH, max_len, device=dev)["sub0"]
    ckv1, krope1 = one["ckv"][0], one["krope"][0]
    x_dec = h0[:, -1:].contiguous()
    calls = {"prefill": lambda: attn.mla_forward(mixer0, h0, cfg),
             "decode": lambda: attn.mla_decode(mixer0, x_dec, cfg, ckv1,
                                               krope1, MLA_PROMPT)}
    syncs = {k: host_syncs(fn) for k, fn in calls.items()}
    layer_ms = {"prefill": time_ms(calls["prefill"], 5),
                "decode": time_ms(calls["decode"], 20)}
    step = {"prefill": prefill_ms, "decode": decode_ms}
    say(f"[phase10] one MLA layer (CUDA events): "
        + ", ".join(f"{k} {layer_ms[k]:.3f} ms (x{cfg.num_layers}: "
                    f"{layer_ms[k] * cfg.num_layers / step[k]:.2f} of the "
                    f"served {k})" for k in layer_ms)
        + f"; host syncs: prefill {len(syncs['prefill'])} "
        f"{syncs['prefill']}, decode {len(syncs['decode'])} "
        f"{syncs['decode']}  [{card}]")
    if syncs["prefill"] or syncs["decode"]:
        raise AssertionError(f"an MLA layer synchronises the host: {syncs}")
    del one, ckv1, krope1

    # (b) layer 0's mixer at full width: the card in bf16 against the CPU
    # in fp32 from the same weights; two controls.
    t = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    xs = h0[:, :MLA_CHECK_TOKENS]
    got = attn.mla_forward(mixer0, xs, cfg).cpu()
    cpu = {k: v.cpu().float() for k, v in mixer0.items()}
    x_cpu = xs.cpu().float()
    want = attn.mla_forward(cpu, x_cpu, cfg32)
    ctl = {"query heads split [nope, rope]": attn.mla_forward(
        nope_first(cpu, cfg), x_cpu, cfg32)}
    with patched(attn, "rms_norm", without_kv_norm(cpu)):
        ctl["expansion without kv_norm"] = attn.mla_forward(cpu, x_cpu,
                                                            cfg32)
    r = rel_err(got, want)
    rc = {name: rel_err(got, x) for name, x in ctl.items()}
    say(f"[phase10] layer 0's MLA mixer on {MLA_BATCH} x {MLA_CHECK_TOKENS} "
        f"prefill tokens, card bf16 vs CPU fp32: ||Δ||/||cpu|| {r:.3e} (tol "
        f"{MLA_LAYER_REL}); controls: " + "; ".join(
            f"{n} {x:.3e}" for n, x in rc.items())
        + f"; in {time.perf_counter() - t:.1f} s  [{card}]")
    if not r <= MLA_LAYER_REL:
        raise AssertionError(f"the card's MLA layer differs from the CPU's: "
                             f"{r}")
    for name, x in rc.items():
        if not x > MLA_LAYER_REL:
            raise AssertionError(f"control {name!r} passes the layer check "
                                 f"({x})")
    del got, cpu, x_cpu, want, ctl

    # (c) the latent cache's handoff: decode token P + 1 after a prefill
    # of P, against the last position of a prefill of P + 1.
    t = time.perf_counter()
    p = MLA_HANDOFF
    nxt = prompts[:, p:p + 1]

    def handoff(model, weights, control=False):
        ref, _ = model.prefill(weights, {"inputs": prompts[:, :p + 1]}, p + 2)
        _, lc = model.prefill(weights, {"inputs": prompts[:, :p]}, p + 2)
        if control:
            lc["sub0"]["krope"].zero_()
        dec, _ = model.decode_step(weights, lc, nxt, p)
        real = slice(0, cfg.vocab_size)
        return dec[:, real], ref[:, real]

    lm32 = LM(cfg32)
    params32 = tree_map(lambda x: x.float(), params)
    dec, ref = handoff(lm32, params32)
    d32 = float((dec - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    held = [i for i, gp in enumerate(gaps) if gp > 2 * d32]
    d_tok, r_tok = dec.argmax(-1).tolist(), ref.argmax(-1).tolist()
    ctl32 = float(torch.sub(*handoff(lm32, params32, control=True))
                  .abs().max())
    del params32, lm32, dec, ref
    d16 = float(torch.sub(*handoff(lm, params)).abs().max())
    ctl16 = float(torch.sub(*handoff(lm, params, control=True)).abs().max())
    say(f"[phase10] latent cache handoff, fp32 copy of the weights: decode "
        f"of token {p + 1} after a {p}-token prefill vs the {p + 1}-token "
        f"prefill's last position: logits max |Δ| {d32:.4e} (tol "
        f"{MLA_HANDOFF_TOL}); first tokens decode {d_tok}, prefill {r_tok}, "
        f"prefill top-1/top-2 gaps " + ", ".join(f"{gp:.4f}" for gp in gaps)
        + f", held to equal: prompts {held}; control (cache krope zeroed): "
        f"{ctl32:.4e}; the served bf16 weights read {d16:.4e}, their "
        f"control {ctl16:.4e} (readings, no bound); in "
        f"{time.perf_counter() - t:.1f} s  [{card}]")
    if not d32 <= MLA_HANDOFF_TOL:
        raise AssertionError(f"decode after prefill differs from the longer "
                             f"prefill: {d32}")
    if any(d_tok[i] != r_tok[i] for i in held):
        raise AssertionError(f"first tokens differ where the bound holds "
                             f"them equal: {d_tok} vs {r_tok}")
    if not ctl32 > MLA_HANDOFF_TOL:
        raise AssertionError(f"a decode with the cache's krope zeroed passes "
                             f"the handoff check ({ctl32})")

    del params, eng, mixer0, h0, seen
    return launches, bodies


# -- phase 11: whisper-base encoder-decoder serving -------------------------
WHISPER_ARCH = "whisper-base"
# 16 clips of 30 s (1500 frames each), each with a 192-token decoder
# prompt (the previous window's text, which long-form transcription
# conditions on), then 64 greedy steps: max_len 264, inside Whisper's
# 448-token text context.
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_DECODE = 16, 192, 64
WHISPER_MAX_LEN = WHISPER_PROMPT + WHISPER_DECODE + 8
# The flash kernel at the served prefill's two non-causal shapes, bf16
# (FLASH_CASES' layout; Sk in WHISPER_FLASH_SK): the encoder's
# self-attention over the frames, and each decoder layer's
# cross-attention of the prompt over them.
WHISPER_FLASH = {
    "whisper_encoder": ("whisper encoder", WHISPER_BATCH, 1500, 8, 1, 64,
                        64, False, torch.bfloat16),
    "whisper_cross": ("whisper cross", WHISPER_BATCH, WHISPER_PROMPT, 8, 1,
                      64, 64, False, torch.bfloat16)}
WHISPER_FLASH_SK = 1500
# Phase 11(b): encoder layer 0's and decoder layer 0's cross-attention on
# WHISPER_CHECK_CLIPS of their served inputs, the card in bf16 against the
# CPU in fp32 from the same bf16 weights: ||Δ|| <= WHISPER_LAYER_REL·
# ||cpu||, the bound phase 10(b) holds MLA to.  The encoder run causal and
# the cross-attention run causal (controls) must fail it.
WHISPER_CHECK_CLIPS = 2
WHISPER_LAYER_REL = 2e-2
# Phase 11(c): decode of token P + 1 after a P-token prefill, in fp32 (a
# copy of the served bf16 weights), against the last position of the
# (P + 1)-token prefill over the same frames: logits within
# WHISPER_HANDOFF_TOL, phase 10(c)'s bound.  The decode with the cache's
# xk zeroed (the control) must fail it.
WHISPER_HANDOFF_TOL = 2e-4


def causal_cross():
    """``models.attention.chunked_attention`` run causal whatever the
    caller asks: patched in, the CPU's cross-attention turns causal."""
    run = attn.chunked_attention

    def causal(*args, **kwargs):
        return run(*args, **dict(kwargs, causal=True))
    return causal


def whisper_flash(dev, card):
    """Phase 11's kernel checks and timings at the served shapes; returns
    (max error, per-body record)."""
    t = time.perf_counter()
    err = 0.0
    bodies = {"wgmma": {}, "mma": {}}
    sk = WHISPER_FLASH_SK
    for key, case in WHISPER_FLASH.items():
        name, b, s, kvh, g, dh, dv, causal, _ = case
        e, (q, k, v, want) = check_flash_case(case, dev, "phase11", sk=sk)
        err = max(err, e)
        ctl = dropped_tile_control(q, k, v, want, causal=False)
        r = rel_err(ctl, want)
        say(f"[phase11] control, {name} (one 64-key tile dropped for the "
            f"last 64 queries) vs plain: ||Δ||/||plain|| {r:.3e}; the bound "
            f"both bodies met above fails at {FLASH_BF16_REL}")
        if not r > FLASH_BF16_REL:
            raise AssertionError(f"the dropped-tile control passes the "
                                 f"{name} check ({r})")
        del q, k, v, want, ctl
        tm = time_flash(b, s, kvh, g, dh, causal, dev, (20, 3), sk=sk)
        bd, by = flash_bound(b, s, kvh, g, dh, dv, causal, sk=sk)
        reads = ", ".join(f"{n} " + " / ".join(f"{x:.4f}" for x in r)
                          for n, r in tm["reads"].items())
        wg, mma, lib = tm["wgmma"], tm["mma"], tm["library"]
        say(f"[phase11] flash {name} (B={b}, Sq={s}, Sk={sk}, H={kvh}, "
            f"dh={dh}, bf16, non-causal): wgmma body {wg:.4f} ms "
            f"({bd / wg:.3f} of the bound), mma body {mma:.4f} ms "
            f"({bd / mma:.3f}), scaled_dot_product_attention {lib:.4f} ms "
            f"(the wgmma body at {lib / wg:.2f}x its speed), plain "
            f"{tm['plain']:.4f} ms; bound {bd:.4f} ms ({by}); readings in "
            f"turns: {reads}  [{card}]")
        for body in bodies:
            bodies[body][key] = {"ms": tm[body], "bound_ms": bd,
                                 "plain_ms": tm["plain"], "library_ms": lib}
    say(f"[phase11] flash checks and timings in "
        f"{time.perf_counter() - t:.1f} s  [{card}]")
    return err, bodies


def phase_whisper(dev, card):
    """Phase 11; returns (launches, max error, per-body flash record at
    whisper's two shapes)."""
    err, bodies = whisper_flash(dev, card)

    # (serve) whisper-base at its published width and depth.
    t = time.perf_counter()
    cfg = get_config(WHISPER_ARCH)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    resident = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    say(f"[phase11] {WHISPER_ARCH}: {cfg.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, d={cfg.d_model}, "
        f"{cfg.num_heads} heads of {cfg.head_dim} (KV {cfg.num_kv_heads}), "
        f"d_ff {cfg.d_ff} ({cfg.ffn_activation}), vocab {cfg.vocab_padded} "
        f"(untied), layout {cfg.layout}; {n_params} parameters, "
        f"{resident / 1e9:.3f} GB made on the card in "
        f"{time.perf_counter() - t:.1f} s; nothing cut  [{card}]")
    eng = ServeEngine(lm, params, max_len=WHISPER_MAX_LEN)
    rng = np.random.default_rng(SEED + 11)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT + 1))).to(dev)
    frames = torch.from_numpy(rng.standard_normal(
        (WHISPER_BATCH, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)).to(dev)
    batch = {"inputs": prompts[:, :WHISPER_PROMPT], "frames": frames}
    eng.generate(dict(batch, inputs=prompts[:, :16]), 2)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = eng.generate(batch, WHISPER_DECODE)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    launches = read_launches()
    by_body = dict(fa.flash_launches_by_body)
    peak = torch.cuda.max_memory_allocated()
    per_prefill = cfg.encoder_layers + 2 * cfg.num_layers
    want_bodies = {name: per_prefill if name == "wgmma" else 0
                   for name in by_body}
    if launches["flash_attention"] != per_prefill or by_body != want_bodies:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times in the "
                             f"serve ({by_body}), not the wgmma body "
                             f"{per_prefill} times (each encoder layer, "
                             f"each decoder layer's self and cross) and no "
                             f"other")
    if tuple(out.shape) != (WHISPER_BATCH, WHISPER_DECODE) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of "
                             f"range [{int(out.min())}, {int(out.max())}]")
    for name in bodies:
        bodies[name]["launches"] = by_body[name]

    enc_ms = time_ms(lambda: lm._encode(params, frames), 5)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = eng.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        raise AssertionError("non-finite prefill logits")
    shapes = {name: tuple(x.shape) for name, x in cache["sub0"].items()}
    nbytes = {name: x.numel() * x.element_size()
              for name, x in cache["sub0"].items()}
    self_kv, cross_kv = nbytes["k"] + nbytes["v"], nbytes["xk"] + nbytes["xv"]
    tok = out[:, :1]
    steps = WHISPER_DECODE - 1
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(steps):
        _, cache = eng.decode_step(cache, tok, WHISPER_PROMPT + i)
        tok = out[:, i + 1:i + 2]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / steps
    del logits, cache
    say(f"[phase11] serve {WHISPER_BATCH} clips x {cfg.encoder_seq} frames, "
        f"{WHISPER_PROMPT}-token prompts + {WHISPER_DECODE} greedy tokens: "
        f"generate {gen_s:.3f} s, launches {launches}, flash by body "
        f"{by_body}; encoder {enc_ms:.3f} ms (CUDA events), prefill "
        f"{prefill_ms:.2f} ms (encoder included; "
        f"{WHISPER_BATCH * WHISPER_PROMPT / prefill_ms:.1f} prompt tokens/"
        f"ms), decode {decode_ms:.3f} ms per step "
        f"({WHISPER_BATCH * 1e3 / decode_ms:.1f} tokens/s); cache {shapes}: "
        f"cross xk/xv {cross_kv / 1e9:.4f} GB beside self k/v "
        f"{self_kv / 1e9:.4f} GB at max_len {WHISPER_MAX_LEN}; peak memory "
        f"{peak / 1e9:.3f} GB (max_memory_allocated), "
        f"{(peak - base) / 1e9:.3f} GB over the {base / 1e9:.3f} GB held "
        f"before the serve  [{card}]")
    say(f"[phase11] request 0's tokens: {out[0].tolist()}")
    profile_serve(eng, batch, out, card,
                  {"prefill": prefill_ms, "decode": decode_ms},
                  tag="phase11")

    # (b) encoder layer 0's and decoder layer 0's cross-attention on
    # WHISPER_CHECK_CLIPS of their served inputs: card bf16 against CPU
    # fp32 from the same weights, each beside its causal control.
    t = time.perf_counter()
    enc_in, cross_in = [], []
    with patched(attn, "attn_forward",
                 first_input(attn.attn_forward, enc_in)), \
            patched(attn, "cross_attn_forward",
                    first_input(attn.cross_attn_forward, cross_in)):
        eng.prefill(batch)
    n = WHISPER_CHECK_CLIPS
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    enc_out = lm._encode(params, frames[:n])
    mixers = {"encoder layer 0": params["encoder"][0]["mixer"],
              "decoder layer 0 cross": params["blocks"][0]["sub0"]["mixer"]}
    cpu = {k: {name: w.cpu().float() for name, w in m.items()}
           for k, m in mixers.items()}
    xe, xc = enc_in[0][:n], cross_in[0][:n]
    xe_cpu, xc_cpu, eo_cpu = (x.cpu().float() for x in (xe, xc, enc_out))
    runs = {"encoder layer 0": (
        attn.attn_forward(mixers["encoder layer 0"], xe, cfg, causal=False),
        attn.attn_forward(cpu["encoder layer 0"], xe_cpu, cfg32,
                          causal=False),
        attn.attn_forward(cpu["encoder layer 0"], xe_cpu, cfg32,
                          causal=True))}
    kv_cpu = _cross_kv(cpu["decoder layer 0 cross"], eo_cpu, cfg32)
    want = attn.cross_attn_forward(cpu["decoder layer 0 cross"], xc_cpu,
                                   kv_cpu, cfg32)
    with patched(attn, "chunked_attention", causal_cross()):
        ctl = attn.cross_attn_forward(cpu["decoder layer 0 cross"], xc_cpu,
                                      kv_cpu, cfg32)
    kv = _cross_kv(mixers["decoder layer 0 cross"], enc_out, cfg)
    runs["decoder layer 0 cross"] = (attn.cross_attn_forward(
        mixers["decoder layer 0 cross"], xc, kv, cfg), want, ctl)
    for name, (got, want, ctl) in runs.items():
        r, rc = rel_err(got.cpu(), want), rel_err(got.cpu(), ctl)
        say(f"[phase11] {name} on {n} clips (Sq {got.shape[1]}), card bf16 "
            f"vs CPU fp32: ||Δ||/||cpu|| {r:.3e} (tol {WHISPER_LAYER_REL}); "
            f"control (run causal) {rc:.3e}  [{card}]")
        if not r <= WHISPER_LAYER_REL:
            raise AssertionError(f"the card's {name} differs from the "
                                 f"CPU's: {r}")
        if not rc > WHISPER_LAYER_REL:
            raise AssertionError(f"the causal control of {name} passes the "
                                 f"layer check ({rc})")
    say(f"[phase11] (b) in {time.perf_counter() - t:.1f} s")
    del enc_in, cross_in, cpu, runs, want, ctl, enc_out

    # (c) the cross cache's handoff: decode token P + 1 after a prefill
    # of P, against the last position of a prefill of P + 1.
    t = time.perf_counter()
    p = WHISPER_PROMPT
    nxt = prompts[:, p:p + 1]

    def handoff(model, weights, control=False):
        ref, _ = model.prefill(weights, dict(batch, inputs=prompts[:, :p + 1]),
                               p + 2)
        _, lc = model.prefill(weights, batch, p + 2)
        if control:
            lc["sub0"]["xk"].zero_()
        dec, _ = model.decode_step(weights, lc, nxt, p)
        real = slice(0, cfg.vocab_size)
        return dec[:, real], ref[:, real]

    lm32 = LM(cfg32)
    params32 = tree_map(lambda x: x.float(), params)
    dec, ref = handoff(lm32, params32)
    d32 = float((dec - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    held = [i for i, gp in enumerate(gaps) if gp > 2 * d32]
    d_tok, r_tok = dec.argmax(-1).tolist(), ref.argmax(-1).tolist()
    ctl32 = float(torch.sub(*handoff(lm32, params32, control=True))
                  .abs().max())
    del params32, lm32, dec, ref
    d16 = float(torch.sub(*handoff(lm, params)).abs().max())
    say(f"[phase11] cross cache handoff, fp32 copy of the weights: decode of "
        f"token {p + 1} after a {p}-token prefill vs the {p + 1}-token "
        f"prefill's last position: logits max |Δ| {d32:.4e} (tol "
        f"{WHISPER_HANDOFF_TOL}); first tokens held equal on {len(held)} of "
        f"{len(gaps)} clips (top-1/top-2 gap > 2|Δ|), smallest gap "
        f"{min(gaps):.4f}; control (cache xk zeroed): {ctl32:.4e}; the served "
        f"bf16 weights read {d16:.4e} (a reading, no bound); in "
        f"{time.perf_counter() - t:.1f} s  [{card}]")
    if not d32 <= WHISPER_HANDOFF_TOL:
        raise AssertionError(f"decode after prefill differs from the longer "
                             f"prefill: {d32}")
    if any(d_tok[i] != r_tok[i] for i in held):
        raise AssertionError(f"first tokens differ where the bound holds "
                             f"them equal: {d_tok} vs {r_tok}")
    if not ctl32 > WHISPER_HANDOFF_TOL:
        raise AssertionError(f"a decode with the cache's xk zeroed passes "
                             f"the handoff check ({ctl32})")
    del params, eng
    return launches, err, bodies


# -- phase 12: paligemma-3b VLM serving ---------------------------------------
PALI_ARCH = "paligemma-3b"
# 8 images of 256 stub patches, each with a 64-token prompt (an
# instruction or a question), then 32 greedy tokens: captioning and visual
# question answering, one image, a short instruction, a short answer.
PALI_BATCH, PALI_PROMPT, PALI_DECODE = 8, 64, 32
# The flash kernel with a prefix (FLASH_CASES' layout): the served
# prefill's shape, whose first 256 positions (the image) every row sees;
# and a ragged prefix of 200, which straddles a key tile of every body, on
# the wgmma body at (64, 64), (128, 128) and (256, 256) (and the mma body
# on their offset copies) and the fp32 fma body at 256.
PALI_FLASH = ("paligemma heads", PALI_BATCH, 256 + PALI_PROMPT, 1, 8, 256,
              256, True, torch.bfloat16)
PALI_RAGGED = 200
PALI_RAGGED_CASES = (
    ("qwen heads", 2, 320, 4, 1, 64, 64, True, torch.bfloat16),
    ("chatglm3 heads", 2, 320, 1, 4, 128, 128, True, torch.bfloat16),
    ("paligemma heads", 2, 320, 1, 8, 256, 256, True, torch.bfloat16),
    ("paligemma heads", 2, 320, 1, 8, 256, 256, True, torch.float32))
# Phase 12(b): layer 0's attention on PALI_CHECK_IMAGES images of the
# served prefill's input, the card in bf16 against the CPU in fp32 from
# the same bf16 weights: ||Δ|| <= PALI_LAYER_REL·||cpu||, the bound
# phases 8-11 hold their layers to.  The card's layer run with
# prefix_len=0 (the control) must fail it.
PALI_CHECK_IMAGES = 2
PALI_LAYER_REL = 2e-2
# Phase 12(c): decode of text token P + 1 after a prefill of the image and
# P tokens, in fp32 (a copy of the served bf16 weights, all 18 layers),
# against the last position of the prefill of the image and P + 1 tokens:
# logits within PALI_HANDOFF_TOL, phase 10(c)'s bound.  The same decode
# after a prefill with vis_proj zeroed (another image in the cache: the
# control) must fail it.
PALI_HANDOFF_TOL = 2e-4


def pali_flash(dev, card):
    """Phase 12(a): the kernel with the prefix at the served shape and a
    ragged one on every body, each beside its control, and the wgmma body
    and the mma body (on an offset copy) timed at the served shape;
    returns (max error, per-body record)."""
    t = time.perf_counter()
    pair = PALI_FLASH[5:7]
    say("[phase12] flash mma and fma bodies, ptxas: " + ptxas_report(
        "flash_attention", r"flash_fwd_(mma_)?kernelILi(\d+)E",
        lambda hit: f"{'mma' if hit[1] else 'fma'} at {hit[2]} columns",
        [f"{b} at {w} columns" for b in ("mma", "fma")
         for w in (64, 128, 256)]) + "; wgmma body: " + ptxas_report(
        "flash_attention", r"flash_fwd_wgmma_kernelILi(256)ELi(256)E",
        lambda hit: f"(dh, dv) = ({hit[1]}, {hit[2]})",
        [f"(dh, dv) = {pair}"]) + f", dynamic shared memory "
        f"{fa.wgmma_smem_bytes(*pair)} bytes")
    name, b, s, kvh, g, dh, dv, causal, _ = PALI_FLASH
    prefix = get_config(PALI_ARCH).vision_tokens
    err = check_flash_case(PALI_FLASH, dev, "phase12", prefix=prefix)[0]
    for case in PALI_RAGGED_CASES:
        err = max(err, check_flash_case(case, dev, "phase12",
                                        prefix=PALI_RAGGED)[0])
    tm = time_flash(b, s, kvh, g, dh, causal, dev, (20, 3), dv=dv,
                    prefix=prefix)
    bd, by = flash_bound(b, s, kvh, g, dh, dv, causal, prefix=prefix)
    wg, mma = tm["wgmma"], tm["mma"]
    lib, lib_causal = tm["library"], tm["library causal"]
    reads = ", ".join(f"{n} " + " / ".join(f"{x:.4f}" for x in r)
                      for n, r in tm["reads"].items())
    say(f"[phase12] flash {name} (B={b}, S={s}, KV={kvh}, G={g}, dh={dh}, "
        f"dv={dv}, bf16, causal, prefix_len={prefix}): wgmma body "
        f"{wg:.4f} ms ({bd / wg:.3f} of the bound, {wg / lib:.2f}x SDPA's "
        f"time), mma body (offset copy) {mma:.4f} ms ({bd / mma:.3f}, "
        f"{mma / lib:.2f}x; wgmma at {mma / wg:.2f}x its speed), "
        f"scaled_dot_product_attention with the prefix-LM mask {lib:.4f} ms "
        f"({bd / lib:.3f}; backend {tm['backend']}), causal without the "
        f"prefix {lib_causal:.4f} ms; plain {tm['plain']:.4f} ms; bound "
        f"{bd:.4f} ms ({by}); readings in turns: {reads}  [{card}]")
    say(f"[phase12] flash checks and timings in "
        f"{time.perf_counter() - t:.1f} s  [{card}]")
    return err, {body: {"paligemma": {
        "ms": tm[body], "bound_ms": bd, "plain_ms": tm["plain"],
        "library_ms": lib, "library": tm["backend"],
        "sdpa_causal_ms": lib_causal}} for body in ("wgmma", "mma")}


def phase_vlm(dev, card):
    """Phase 12; returns (launches, max error, per-body flash record at
    paligemma's served prefill)."""
    err, rec = pali_flash(dev, card)

    # (serve) paligemma-3b at its published width and depth.
    t = time.perf_counter()
    cfg = get_config(PALI_ARCH)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    resident = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    say(f"[phase12] {PALI_ARCH}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{cfg.num_heads} heads of {cfg.head_dim} (KV {cfg.num_kv_heads}), "
        f"d_ff {cfg.d_ff} ({cfg.ffn_activation}), vocab {cfg.vocab_padded} "
        f"(untied), {cfg.vision_tokens} vision tokens of "
        f"{cfg.vision_embed_dim} through vis_proj; {n_params} parameters, "
        f"{resident / 1e9:.3f} GB made on the card in "
        f"{time.perf_counter() - t:.1f} s; nothing cut  [{card}]")
    vis = cfg.vision_tokens
    max_len = vis + PALI_PROMPT + PALI_DECODE + 8
    eng = ServeEngine(lm, params, max_len=max_len)
    rng = np.random.default_rng(SEED + 12)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PALI_BATCH, PALI_PROMPT + 1))).to(dev)
    patches = torch.from_numpy(rng.standard_normal(
        (PALI_BATCH, vis, cfg.vision_embed_dim)).astype(np.float32)).to(dev)
    batch = {"inputs": prompts[:, :PALI_PROMPT], "patches": patches}
    eng.generate(dict(batch, inputs=prompts[:, :16]), 2)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = eng.generate(batch, PALI_DECODE)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    launches = read_launches()
    by_body = dict(fa.flash_launches_by_body)
    peak = torch.cuda.max_memory_allocated()
    want_bodies = {name: cfg.num_layers if name == "wgmma" else 0
                   for name in by_body}
    if launches["flash_attention"] != cfg.num_layers or \
            by_body != want_bodies:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times in the "
                             f"serve ({by_body}), not the wgmma body once a "
                             f"layer ({cfg.num_layers}) and no other")
    if tuple(out.shape) != (PALI_BATCH, PALI_DECODE) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(out.shape)} out of "
                             f"range [{int(out.min())}, {int(out.max())}]")
    bodies = {name: dict(rec.get(name, {}), launches=by_body[name])
              for name in by_body}

    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = eng.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        raise AssertionError("non-finite prefill logits")
    kv_bytes = sum(x.numel() * x.element_size()
                   for x in cache["sub0"].values())
    shapes = {name: tuple(x.shape) for name, x in cache["sub0"].items()}
    tok = out[:, :1]
    steps = PALI_DECODE - 1
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(steps):
        _, cache = eng.decode_step(cache, tok, vis + PALI_PROMPT + i)
        tok = out[:, i + 1:i + 2]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / steps
    del logits, cache
    say(f"[phase12] serve {PALI_BATCH} images x {vis} patches with "
        f"{PALI_PROMPT}-token prompts + {PALI_DECODE} greedy tokens: "
        f"generate {gen_s:.3f} s, launches {launches}, flash by body "
        f"{by_body}; prefill {prefill_ms:.2f} ms "
        f"({PALI_BATCH * (vis + PALI_PROMPT) / prefill_ms:.1f} positions/"
        f"ms), decode {decode_ms:.3f} ms per step "
        f"({PALI_BATCH * 1e3 / decode_ms:.1f} tokens/s); K/V cache {shapes}"
        f" = {kv_bytes / 1e9:.4f} GB at max_len {max_len}; peak memory "
        f"{peak / 1e9:.3f} GB (max_memory_allocated), "
        f"{(peak - base) / 1e9:.3f} GB over the {base / 1e9:.3f} GB held "
        f"before the serve  [{card}]")
    say(f"[phase12] request 0's tokens: {out[0].tolist()}")
    profile_serve(eng, batch, out, card,
                  {"prefill": prefill_ms, "decode": decode_ms},
                  tag="phase12")

    # (b) layer 0's attention on PALI_CHECK_IMAGES images of the served
    # prefill's input: card bf16 against CPU fp32 from the same weights,
    # beside the card's run without the prefix.
    t = time.perf_counter()
    seen = []
    with patched(attn, "attn_forward", first_input(attn.attn_forward, seen)):
        eng.prefill(batch)
    h0 = seen[0][:PALI_CHECK_IMAGES]
    mixer0 = params["blocks"][0]["sub0"]["mixer"]
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    got = attn.attn_forward(mixer0, h0, cfg, prefix_len=vis).cpu()
    ctl = attn.attn_forward(mixer0, h0, cfg, prefix_len=0).cpu()
    cpu = {name: w.cpu().float() for name, w in mixer0.items()}
    want = attn.attn_forward(cpu, h0.cpu().float(), cfg32, prefix_len=vis)
    r, rc = rel_err(got, want), rel_err(ctl, want)
    say(f"[phase12] layer 0's attention on {PALI_CHECK_IMAGES} images "
        f"({vis} + {PALI_PROMPT} positions, prefix_len {vis}), card bf16 vs "
        f"CPU fp32: ||Δ||/||cpu|| {r:.3e} (tol {PALI_LAYER_REL}); control "
        f"(the card's layer with prefix_len=0) {rc:.3e}; in "
        f"{time.perf_counter() - t:.1f} s  [{card}]")
    if not r <= PALI_LAYER_REL:
        raise AssertionError(f"the card's layer 0 differs from the CPU's: "
                             f"{r}")
    if not rc > PALI_LAYER_REL:
        raise AssertionError(f"the prefix_len=0 control passes the layer "
                             f"check ({rc})")
    del seen, h0, got, ctl, cpu, want

    # (c) the handoff after the image: decode text token P + 1 after a
    # prefill of the image and P tokens, against the last position of the
    # prefill of the image and P + 1 tokens.
    t = time.perf_counter()
    p = PALI_PROMPT
    nxt = prompts[:, p:p + 1]
    real = slice(0, cfg.vocab_size)

    def handoff(model, weights, control=False):
        """(decode logits, the longer prefill's) over the real vocabulary;
        ``control`` makes the cache from a prefill with ``vis_proj``
        zeroed."""
        ref, _ = model.prefill(weights, dict(batch, inputs=prompts[:, :p + 1]),
                               vis + p + 2)
        image = weights
        if control:
            image = dict(weights, vis_proj=torch.zeros_like(
                weights["vis_proj"]))
        _, lc = model.prefill(image, batch, vis + p + 2)
        dec, _ = model.decode_step(weights, lc, nxt, vis + p)
        return dec[:, real], ref[:, real]

    lm32 = LM(cfg32)
    params32 = tree_map(lambda x: x.float(), params)
    dec, ref = handoff(lm32, params32)
    d32 = float((dec - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    held = [i for i, gp in enumerate(gaps) if gp > 2 * d32]
    d_tok, r_tok = dec.argmax(-1).tolist(), ref.argmax(-1).tolist()
    ctl32 = float(torch.sub(*handoff(lm32, params32, control=True))
                  .abs().max())
    del params32, lm32, dec, ref
    d16 = float(torch.sub(*handoff(lm, params)).abs().max())
    say(f"[phase12] handoff after the image, fp32 copy of the weights (all "
        f"{cfg.num_layers} layers): decode of text token {p + 1} after a "
        f"{vis} + {p}-position prefill vs the {vis} + {p + 1}-position "
        f"prefill's last position: logits max |Δ| {d32:.4e} (tol "
        f"{PALI_HANDOFF_TOL}); first tokens held equal on {len(held)} of "
        f"{len(gaps)} prompts (top-1/top-2 gap > 2|Δ|), smallest gap "
        f"{min(gaps):.4f}; control (the cache's image through a zeroed "
        f"vis_proj): {ctl32:.4e}; the served bf16 weights read {d16:.4e} "
        f"(a reading, no bound); in {time.perf_counter() - t:.1f} s  "
        f"[{card}]")
    if not d32 <= PALI_HANDOFF_TOL:
        raise AssertionError(f"decode after prefill differs from the longer "
                             f"prefill: {d32}")
    if any(d_tok[i] != r_tok[i] for i in held):
        raise AssertionError(f"first tokens differ where the bound holds "
                             f"them equal: {d_tok} vs {r_tok}")
    if not ctl32 > PALI_HANDOFF_TOL:
        raise AssertionError(f"a decode after a zeroed-vis_proj prefill "
                             f"passes the handoff check ({ctl32})")
    del params, eng, mixer0
    return launches, err, bodies


# -- phase 13: training qwen1.5-0.5b (the twentieth slice) ------------------
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 4
# (name, b, sq, sk, kv heads, g, dh, dv, causal, prefix_len, dtype) of
# phase 13(a): the training shape, llama4's GQA heads, minicpm3's MLA
# pair, whisper's non-causal cross shape, paligemma's prefix-LM heads of
# 256, and one fp32 shape.
BWD_CASES = (
    ("qwen training", 8, 2048, 2048, 16, 1, 64, 64, True, 0, torch.bfloat16),
    ("llama4 GQA", 4, 2000, 2000, 8, 5, 128, 128, True, 0, torch.bfloat16),
    ("minicpm3 MLA", 4, 2000, 2000, 40, 1, 96, 64, True, 0, torch.bfloat16),
    ("whisper cross", 16, 192, 1500, 8, 1, 64, 64, False, 0,
     torch.bfloat16),
    ("paligemma prefix", 8, 320, 320, 1, 8, 256, 256, True, 256,
     torch.bfloat16),
    ("qwen heads fp32", 2, 1000, 1000, 16, 1, 64, 64, True, 0,
     torch.float32),
)
# The kernel's dq, dk and dv against the plain version's, each in norm:
# ||Δ|| <= BWD_REL·||plain||.  Both sum in fp32 and round P and dS to the
# inputs' dtype at the same points; they differ in sum order and expf, so
# bf16 may round a P or dS the other way (the first H100 run read
# 1.6e-4-2.8e-4 in bf16, 6.2e-7 in fp32).  A control (the mask's diagonal
# shifted by one, the prefix ignored, or a non-causal call run causal)
# must fail.
BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
# Phase 13(c): the card's bf16 loss and layer 0's wq gradient on one
# TRAIN_CHECK batch, against the CPU's fp32 run of the same weights: the
# loss within TRAIN_LOSS_REL relative and the gradient within
# TRAIN_GRAD_REL in norm (bf16 rounds every activation through 24 layers
# and their backward; the first H100 runs read 9.9e-5 and 3.4e-2, so each
# bound is about 10x and 3x its reading).  The backward with its mask off
# (the control; it read 1.0) must fail the gradient's bound.
TRAIN_CHECK = (1, 256)
TRAIN_LOSS_REL = 1e-3
TRAIN_GRAD_REL = 1e-1
# Phase 13(d): checkpoint/restart at the full width and TRAIN_RESTART_LAYERS
# layers (the full depth's 4.6 GB of params, m and v stay off the disk):
# steps 3 and 4 after a restart at step 2 against the uninterrupted run's,
# |Δ| <= TRAIN_RESTART_TOL·loss.  The state comes back bit for bit; what
# may differ is the card's order of sums in the atomics of a few torch ops
# (the embedding's gradient).
TRAIN_RESTART_LAYERS = 2
TRAIN_RESTART_TOL = 1e-3


def bwd_inputs(case, dev, seed):
    """Seeded q, k, v and dO of a ``BWD_CASES`` entry on the card, and o
    from the forward kernel."""
    _, b, sq, sk, kvh, g, dh, dv, causal, prefix, dt = case
    q, k, v = attention_inputs(b, sq, kvh, g, dh, dv, dt, dev, seed, sk=sk)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn((b, sq, kvh, g, dv), generator=gen, device=dev).to(dt)
    o = fa.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
    return q, k, v, o, do


def shifted_diagonal_bwd(q, k, v, do):
    """The plain gradient of causal attention whose diagonal is shifted by
    one (row r sees keys up to r + 1): the plain function on q with one
    row of zeros in front, which moves every row's position up by one, and
    a zero cotangent for that row."""
    pad = torch.zeros_like(q[:, :1])
    qs = torch.cat([pad, q], 1)
    dos = torch.cat([torch.zeros_like(do[:, :1]), do], 1)
    os_ = fa.flash_attention_plain(qs, k, v)
    dq, dk, dv = fa.flash_attention_bwd_plain(qs, k, v, os_, dos)
    return dq[:, 1:], dk, dv


def bwd_rel(got, want) -> float:
    return max(float((a.float() - w.float()).norm() / w.float().norm())
               for a, w in zip(got, want))


def check_bwd_case(case, dev, seed) -> float:
    """Phase 13(a) for one case: the kernel against its plain version and
    the control; returns the largest absolute error."""
    name, b, sq, sk, kvh, g, dh, dv, causal, prefix, dt = case
    q, k, v, o, do = bwd_inputs(case, dev, seed)
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                 prefix_len=prefix)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                        prefix_len=prefix)
    if any(not bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError(f"flash backward {name}: non-finite values")
    rel = bwd_rel(got, want)
    err = max(float((a.float() - w.float()).abs().max())
              for a, w in zip(got, want))
    if not rel <= BWD_REL[dt]:
        raise AssertionError(f"flash backward {name} vs plain: "
                             f"||Δ||/||plain|| {rel} > {BWD_REL[dt]}")
    if prefix:
        what = "prefix_len ignored"
        rc = bwd_rel(fa.flash_attention_bwd(q, k, v, o, do, causal=causal),
                     want)
    elif causal:
        what = "against the plain gradient with the diagonal shifted by one"
        rc = bwd_rel(got, shifted_diagonal_bwd(q, k, v, do))
    else:
        what = "run causal"
        rc = bwd_rel(fa.flash_attention_bwd(q, k, v, o, do, causal=True),
                     want)
    if not rc > BWD_REL[dt]:
        raise AssertionError(f"the control ({what}) passes the {name} "
                             f"backward check ({rc})")
    say(f"[phase13] flash backward vs plain, {name} (B={b}, Sq={sq}, "
        f"Sk={sk}, KV={kvh}, G={g}, dh={dh}, dv={dv}, causal={causal}, "
        f"prefix_len={prefix}, {dt}): ||Δ||/||plain|| {rel:.3e} (bound "
        f"{BWD_REL[dt]}), max |Δ| {err:.3e}; control ({what}) {rc:.3e}")
    return err


def bwd_bound(b, s, kvh, g, dh, dv, dtype_bytes=2) -> tuple[float, str]:
    """Least time of one causal backward at Sq = Sk = s: 2.5x the
    forward's flops on the unmasked (q, k) pairs (2·dh for the score,
    2·dv for P·V) over the bf16 tensor-core rate, or its bytes (q, k, v,
    o and dO read once, dq, dk and dv written once) over the memory
    rate."""
    pairs = b * kvh * g * s * (s + 1) // 2
    t_ops = 2.5 * 2 * (dh + dv) * pairs / BF16_FLOPS_PER_S * 1e3
    nbytes = dtype_bytes * b * s * kvh * (2 * g * dh + 2 * g * dv
                                          + 2 * dh + 2 * dv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_bwd(case, dev, iters) -> dict:
    """Phase 13(b): the backward kernel and the backward of
    ``scaled_dot_product_attention`` through autograd (a yardstick the
    port never calls, on the same tensors viewed as (B, H, S, d); the
    backend its dispatcher picks named) in turns, queued behind a spin
    kernel (:func:`queued_ms`), and the plain version."""
    name, b, sq, sk, kvh, g, dh, dv, causal, prefix, dt = case
    q, k, v, o, do = bwd_inputs(case, dev, SEED + 31)
    p = functools.partial
    h = kvh * g
    qs = q.view(b, sq, h, dh).transpose(1, 2).detach().requires_grad_()
    ks_ = k.transpose(1, 2).detach().requires_grad_()
    vs = v.transpose(1, 2).detach().requires_grad_()
    sdpa = p(torch.nn.functional.scaled_dot_product_attention, qs, ks_, vs,
             is_causal=causal, enable_gqa=g > 1)
    out = sdpa()
    dos = do.view(b, sq, h, dv).transpose(1, 2)
    runs = {"kernel": p(fa.flash_attention_bwd, q, k, v, o, do,
                        causal=causal, prefix_len=prefix),
            "library": p(torch.autograd.grad, out, (qs, ks_, vs), dos,
                         retain_graph=True)}
    tm = in_turns(runs, iters, timer=queued_ms)
    tm["plain"] = time_ms(p(fa.flash_attention_bwd_plain, q, k, v, o, do,
                            causal=causal, prefix_len=prefix), 2)
    tm["backend"] = sdpa_backend(sdpa)
    return tm


def train_profile(tr, step_ms, card) -> None:
    """``torch.profiler`` over one more training step: the card's busy ms
    (kernel time summed), its share of the unprofiled step's host ms, the
    kernel launches the profiler counted and the kernels that take the
    most time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("ignore", UserWarning)
        t = time.perf_counter()
        tr.run(steps=tr.step + 1)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    total = sum(busy.values())
    count = sum(e.count for e in kernels
                if not e.key.startswith(("Memcpy", "Memset")))
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    say(f"[phase13] profile of one training step: card busy {total:.3f} ms,"
        f" {total / step_ms:.2f} of the unprofiled {step_ms:.3f} ms "
        f"(profiled host {prof_ms:.3f} ms), {count} kernel launches; top "
        f"kernels: " + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top)
        + f"  [{card}]")


def loss_and_grad(lm, params, batch, leaf):
    """``lm.loss`` and its gradient with respect to one leaf (fp32, on the
    host)."""
    loss, _ = lm.loss(params, batch)
    (grad,) = torch.autograd.grad(loss, [leaf])
    return float(loss.detach()), grad.float().cpu()


def check_train_against_cpu(tr, dev, card) -> None:
    """Phase 13(c)'s parity: the trained weights' bf16 loss and layer 0's
    wq gradient on the card against the CPU's fp32 run of the same
    weights, on one TRAIN_CHECK batch, beside the mask-off control."""
    from repro_torch.data.pipeline import SyntheticLM
    t = time.perf_counter()
    cfg = tr.lm.cfg
    b, s = TRAIN_CHECK
    batch = SyntheticLM(cfg.vocab_size, s, b, seed=SEED + 13).batch_at(0)
    card_batch = {n: x.to(dev) for n, x in batch.items()}
    wq = tr.params["blocks"][0]["sub0"]["mixer"]["wq"]
    loss, grad = loss_and_grad(tr.lm, tr.params, card_batch, wq)

    bwd = fa.flash_attention_bwd

    def mask_off(q, k, v, o, do, *, causal=True, prefix_len=0):
        return bwd(q, k, v, o, do, causal=False, prefix_len=prefix_len)

    with patched(fa, "flash_attention_bwd", mask_off):
        _, ctl = loss_and_grad(tr.lm, tr.params, card_batch, wq)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32", remat=False)
    host = tree_map(lambda x: x.detach().float().cpu(), tr.params)
    hwq = host["blocks"][0]["sub0"]["mixer"]["wq"].requires_grad_()
    want, wgrad = loss_and_grad(LM(cfg32), host, batch, hwq)
    dl = abs(loss - want) / abs(want)
    dg = float((grad - wgrad).norm() / wgrad.norm())
    dc = float((ctl - wgrad).norm() / wgrad.norm())
    say(f"[phase13] B={b}, S={s} on the trained weights: card bf16 loss "
        f"{loss:.5f} vs CPU fp32 {want:.5f} (|Δ|/loss {dl:.3e}, bound "
        f"{TRAIN_LOSS_REL}); layer 0's wq gradient ||Δ||/||cpu|| {dg:.3e} "
        f"(bound {TRAIN_GRAD_REL}); control (the backward's mask off) "
        f"{dc:.3e}; {time.perf_counter() - t:.1f} s  [{card}]")
    if not (dl <= TRAIN_LOSS_REL and dg <= TRAIN_GRAD_REL):
        raise AssertionError(f"card training step vs CPU: loss {dl}, wq "
                             f"gradient {dg}")
    if not dc > TRAIN_GRAD_REL:
        raise AssertionError(f"the mask-off backward passes the gradient "
                             f"check ({dc})")


def check_restart(dev, card) -> None:
    """Phase 13(d): TRAIN_STEPS steps uninterrupted against 2 steps, a
    checkpoint, a fresh Trainer that restores it and 2 more, at the full
    width and TRAIN_RESTART_LAYERS layers."""
    import shutil

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    t = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAIN_RESTART_LAYERS)
    lm = LM(cfg)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    # The launcher's optimizer for TRAIN_STEPS steps.
    opt = OptimizerConfig(lr=1e-3, warmup_steps=TRAIN_STEPS,
                          total_steps=TRAIN_STEPS)
    ckpt = os.path.join(ROOT, "build", "phase13_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)

    def trainer(steps, ckpt_dir=None):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return Trainer(lm, data.batch_at, TrainConfig(
            steps=steps, ckpt_dir=ckpt_dir, ckpt_every=2, opt=opt),
            generator=gen)

    def losses(tr, out):
        tr.run(on_step=lambda t: out.append(float(t.metrics["loss"])))
        return out

    whole = losses(trainer(TRAIN_STEPS), [])
    parts = losses(trainer(2, ckpt), [])
    size = os.path.getsize(os.path.join(ckpt, "step_00000002.npz"))
    t1 = time.perf_counter()
    resumed = trainer(TRAIN_STEPS, ckpt)
    restore_s = time.perf_counter() - t1
    if resumed.step != 2:
        raise AssertionError(f"the restarted trainer is at step "
                             f"{resumed.step}, not 2")
    parts = losses(resumed, parts)
    shutil.rmtree(ckpt)
    worst = max(abs(a - b) / a for a, b in zip(whole, parts))
    say(f"[phase13] restart at {TRAIN_RESTART_LAYERS} of "
        f"{get_config(TRAIN_ARCH).num_layers} layers, full width (the full "
        f"depth's state stays off the disk): losses uninterrupted "
        f"{[round(x, 6) for x in whole]}, restarted at step 2 "
        f"{[round(x, 6) for x in parts]}; max |Δ|/loss {worst:.3e} (bound "
        f"{TRAIN_RESTART_TOL}); checkpoint {size / 1e9:.3f} GB, a fresh "
        f"Trainer restored it in {restore_s:.1f} s; "
        f"{time.perf_counter() - t:.1f} s  [{card}]")
    if len(parts) != TRAIN_STEPS or not worst <= TRAIN_RESTART_TOL:
        raise AssertionError(f"restart: {whole} vs {parts}")


def phase_train(dev, card, t_run):
    """Phase 13; returns (launches, max error, timings, bound, the forward
    kernel's launches by body) of the training run."""
    from repro_torch.launch import train as tlaunch

    widths = (64, 128, 256)
    say("[phase13] flash backward (bf16 builds), ptxas: " + ptxas_report(
        "flash_attention_bwd",
        r"flash_bwd_(stats|dkdv|dq)_kernelI13__nv_bfloat16Li(\d+)E",
        lambda hit: f"{hit[1]} at {hit[2]} columns",
        [f"{k} at {w} columns" for k in ("stats", "dkdv", "dq")
         for w in widths]))
    # (a) the backward kernel against its plain version, with controls.
    t = time.perf_counter()
    err = 0.0
    for i, case in enumerate(BWD_CASES):
        err = max(err, check_bwd_case(case, dev, SEED + 13 + i))
    say(f"[phase13] backward checks in {time.perf_counter() - t:.1f} s")

    # (b) times at the training shape.
    t = time.perf_counter()
    case = BWD_CASES[0]
    _, b, s, _, kvh, g, dh, dv = case[:8]
    iters = 10 if time.perf_counter() - t_run < SLOW_RUN_S else 5
    tm = time_bwd(case, dev, iters)
    bd, by = bwd_bound(b, s, kvh, g, dh, dv)
    reads = ", ".join(f"{n} " + " / ".join(f"{x:.4f}" for x in r)
                      for n, r in tm["reads"].items())
    say(f"[phase13] flash backward at the training shape (B={b}, S={s}, "
        f"KV={kvh}, G={g}, dh={dh}, dv={dv}, bf16, causal): kernel "
        f"{tm['kernel']:.4f} ms ({bd / tm['kernel']:.3f} of the bound, "
        f"{tm['kernel'] / tm['library']:.2f}x SDPA-backward's time), "
        f"scaled_dot_product_attention's backward {tm['library']:.4f} ms "
        f"({bd / tm['library']:.3f}; backend {tm['backend']}), plain "
        f"{tm['plain']:.4f} ms; bound {bd:.4f} ms ({by}); readings in "
        f"turns: {reads}; {time.perf_counter() - t:.1f} s  [{card}]")

    # (c) train qwen1.5-0.5b at full width and depth through the launcher.
    cfg = get_config(TRAIN_ARCH)
    marks = []

    def on_step(tr):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), float(tr.metrics["loss"]),
                      fa.flash_launches, fa.flash_bwd_launches,
                      dict(fa.flash_launches_by_body)))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t = time.perf_counter()
    tr = tlaunch.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                       "--seq", str(TRAIN_SEQ), "--global-batch",
                       str(TRAIN_BATCH)], on_step=on_step)
    torch.cuda.synchronize()
    launches = read_launches()
    by_body = dict(fa.flash_launches_by_body)
    peak = torch.cuda.max_memory_allocated() - base
    losses = [m[1] for m in marks]
    step_ms = [(b2[0] - b1[0]) * 1e3 for b1, b2 in zip(marks, marks[1:])]
    first_ms = (marks[0][0] - t) * 1e3
    fwd_per = [b2[2] - b1[2] for b1, b2 in zip([(0, 0, 0, 0)] + marks,
                                                marks)]
    bwd_per = [b2[3] - b1[3] for b1, b2 in zip([(0, 0, 0, 0)] + marks,
                                                marks)]
    n = sum(x.numel() for x in tree_leaves(tr.params))
    state = {"params": 2 * n, "grads": 2 * n, "m": 4 * n, "v": 4 * n,
             "checkpointed activations": (cfg.num_layers + 1) * TRAIN_BATCH
             * TRAIN_SEQ * cfg.d_model * 2}
    mean_ms = float(np.mean(step_ms))
    say(f"[phase13] {TRAIN_ARCH} trained through repro_torch.launch.train "
        f"({cfg.num_layers} layers, d={cfg.d_model}, {n / 1e6:.1f} M params "
        f"in bf16, AdamW fp32 moments, remat), {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: losses "
        f"{[round(x, 5) for x in losses]}; step 1 (weights made on the card "
        f"and first calls) {first_ms:.1f} ms, steps 2-{TRAIN_STEPS} "
        f"{[round(x, 1) for x in step_ms]} ms, mean {mean_ms:.1f} ms = "
        f"{TRAIN_BATCH * TRAIN_SEQ / mean_ms * 1e3:.0f} tokens/s; flash "
        f"launches a step: forward {fwd_per} (by body {by_body}), backward "
        f"{bwd_per}; peak allocated {peak / 1e9:.3f} GB beside "
        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in state.items())
        + f" (sum {sum(state.values()) / 1e9:.3f} GB)  [{card}]")
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}")
    if bwd_per != [cfg.num_layers] * TRAIN_STEPS or \
            fwd_per != [2 * cfg.num_layers] * TRAIN_STEPS or \
            by_body["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"flash launches a step: forward {fwd_per} "
                             f"({by_body}), backward {bwd_per}; want "
                             f"{2 * cfg.num_layers} (remat recomputes each "
                             f"period) and {cfg.num_layers}")
    train_profile(tr, mean_ms, card)
    check_train_against_cpu(tr, dev, card)
    del tr
    torch.cuda.empty_cache()

    # (d) checkpoint/restart on the card.
    check_restart(dev, card)
    record = {"ms": tm["kernel"], "plain_ms": tm["plain"],
              "library_ms": tm["library"], "library": tm["backend"]}
    return launches, err, record, (bd, by), by_body


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_run = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(card)
    say(f"device: {kind}  count: {torch.cuda.device_count()}  torch "
        f"{torch.__version__}  cuda {torch.version.cuda}")
    say(json.dumps({"kernel_names": sorted(KERNELS)}))

    # One nvcc per kernel source, all started together.
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        builds = {name: pool.submit(b) for name, b in (
            ("serpens_spmv", ks.build), ("flash_attention", fa.build),
            ("flash_attention_bwd", fa.build_bwd))}
        for name, fut in builds.items():
            path, log = fut.result()
            BUILD_LOGS[name] = log
            say(f"[build] {path.name}")
            if log.strip():
                say(log.strip())
    say(f"[build] the three kernel sources in {time.perf_counter() - t:.1f}"
        f" s")

    # -- setup: the G7 stand-in, encoded once by the registry -------------
    t = time.perf_counter()
    rows, cols, vals, shape, meta = paper_matrix("G7", scale=1.0, seed=SEED)
    m, k = shape
    say(f"[setup] G7 {meta['name']} stand-in {m} x {k}, nnz {vals.size}, "
        f"generated in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    reg = MatrixRegistry(byte_budget=16 << 30, device="cuda", verify="fast")
    mid, _ = gated_put(reg, "G7", rows, cols, vals, shape, "sentinel")
    op = reg.get(mid)
    plan = op.plan
    say(f"[setup] registry put (encode + verify + bind) "
        f"{time.perf_counter() - t:.1f}"
        f" s: {plan.idx.size} slots, padding {plan.padding_ratio:.3f}, "
        f"{plan.stream_bytes / 1e6:.1f} MB stream, "
        f"{op.device_bytes / 1e6:.1f} MB on the card")

    # -- phase 1: kernels against their plain versions ---------------------
    t = time.perf_counter()
    rng = np.random.default_rng(SEED)
    errs = {"spmv": 0.0, "spmm": 0.0}
    idx, val, seg, geo = stream_on_card(plan, dev)
    kp = plan.num_segments_local * plan.config.segment_width
    tpc = plan.config.tiles_per_chunk
    x1 = ops.pad_x(torch.from_numpy(
        rng.standard_normal(k).astype(np.float32)).to(dev),
        plan.num_segments_local, plan.config.segment_width)
    say("[phase1] spmv stream pass, ptxas: " + ptxas_report(
        "serpens_spmv", r"spmv_kernelI(f|13__nv_bfloat16)E", value_type,
        ("fp32", "bf16")))
    lanes = plan.config.lanes
    # A plan forced to two row windows of 8 lanes, 4 splits.
    multi = ks.spmv_plan_of(lanes, geo["num_rows_padded"], 8, 2, 4)
    for label, forced in (("G7 fp32 stream", None),
                          ("G7 fp32 stream, forced windows", multi)):
        e, line = compare_spmv(label, idx, val, seg, x1, geo, tpc, forced)
        errs["spmv"] = max(errs["spmv"], e)
        say(f"[phase1] {line}")
    say("[phase1] spmm instantiations, ptxas: " + ptxas_report(
        "serpens_spmv", r"spmm_kernelI(f|13__nv_bfloat16)Li(\d)E",
        lambda hit: f"{value_type(hit)} v{hit[2]}",
        [f"{t} v{n}" for t in ("fp32", "bf16") for n in (1, 2, 4)]))

    def spmm_cases(label, sidx, sval, sseg, sgeo, stpc, skp, sk, ns):
        """Every vector width (N = 16 or 64: v4 in row windows; 2: v2;
        3, and 16 one element into its storage: v1) against plain."""
        for n, offset in ns:
            xn = torch.from_numpy(rng.standard_normal(
                (sk, n)).astype(np.float32)).to(dev)
            xn = ops.pad_rows(xn, skp)
            if offset:
                xn = offset_copy(xn)
            e, line = check_spmm(f"{label} N={n}", sidx, sval, sseg, xn,
                                 sgeo, stpc)
            errs["spmm"] = max(errs["spmm"], e)
            say(f"[phase1] {label}: {line}"
                + (" [X one element into its storage]" if offset else ""))

    spmm_cases("G7 fp32", idx, val, seg, geo, tpc, kp, k,
               ((16, 0), (2, 0), (3, 0), (16, 1)))

    bf_plan = cpart.make_plan(
        rows, cols, vals, shape,
        sformat.SerpensConfig(value_dtype="bfloat16"), cpart.PlanSpec())
    bidx, bval, bseg, bgeo = stream_on_card(bf_plan, dev)
    if bval.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 stream arrived as {bval.dtype}")
    e, line = compare_spmv("G7 bf16 stream", bidx, bval, bseg, x1, bgeo,
                           tpc)
    errs["spmv"] = max(errs["spmv"], e)
    say(f"[phase1] {line}")
    spmm_cases("G7 bf16", bidx, bval, bseg, bgeo, tpc, kp, k,
               ((16, 0), (2, 0), (3, 0)))

    r2, c2, v2, shape2, _ = paper_matrix("G7", scale=0.1, seed=SEED)
    opt_plan = cpart.make_plan(r2, c2, v2, shape2, sformat.OPTIMIZED_CONFIG,
                               cpart.PlanSpec())
    oidx, oval, oseg, ogeo = stream_on_card(opt_plan, dev)
    ocfg = opt_plan.config
    okp = opt_plan.num_segments_local * ocfg.segment_width
    xo = rng.standard_normal(shape2[1]).astype(np.float32)
    xo_d = ops.pad_rows(torch.from_numpy(xo).to(dev), okp)
    e1, line = compare_spmv("G7 x0.1 OPTIMIZED_CONFIG stream", oidx, oval,
                            oseg, xo_d, ogeo, ocfg.tiles_per_chunk)
    errs["spmv"] = max(errs["spmv"], e1)
    say(f"[phase1] {line}")
    spmm_cases("G7 x0.1 OPTIMIZED_CONFIG", oidx, oval, oseg, ogeo,
               ocfg.tiles_per_chunk, okp, shape2[1],
               ((64, 0), (16, 0), (2, 0), (3, 0)))
    oop = SerpensOperator(opt_plan, device=dev)
    ref, scale = host_reference(r2, c2, v2.astype(np.float64), shape2[0],
                                xo, 1.0, 0.0, None)
    e3 = check_close("OPTIMIZED operator (stream + aux spill) vs fp64",
                     oop.matvec(xo).cpu(), torch.from_numpy(ref).float(),
                     torch.from_numpy(scale).float())
    say(f"[phase1] G7 x0.1 OPTIMIZED_CONFIG ({opt_plan.n_aux} spilled): "
        f"spmv err {e1:.3e}, operator vs fp64 {e3:.3e}")
    del oop, oidx, oval, oseg, xo_d
    opt_src = (r2, c2, v2, shape2, opt_plan)
    say(f"[phase1] ok in {time.perf_counter() - t:.1f} s")

    # -- phase 2: the server answers requests (the main path) -------------
    reqs = make_requests(np.random.default_rng(SEED + 1), m, k)
    t = time.perf_counter()
    vals64 = vals.astype(np.float64)
    refs = [host_reference(rows, cols, vals64, m, x, a, b, y)
            for x, a, b, y, _ in reqs]
    say(f"[phase2] fp64 host references in {time.perf_counter() - t:.1f} s")
    svc = SpMVService(reg, max_bucket=16, device="cuda")
    launches = {}
    by_width = {}
    rps = {}
    t2 = time.perf_counter()
    for run, drive in (("sync", serve_sync), ("pipelined", serve_pipelined)):
        obs.clear()
        obs.enable()
        zero_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = drive(svc, mid, reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches[run] = read_launches()
        by_width[run] = dict(ks.spmm_launches_by_width)
        obs.disable()
        spans = span_seconds()
        rps[run] = len(res) / dt
        worst = check_results(f"{run} service vs fp64 reference", res, refs)
        say(f"[phase2] {run}: {len(res)} requests in {dt:.3f} s "
            f"({rps[run]:.1f} req/s), launches {launches[run]}, spmm "
            f"launches by width {by_width[run]}, "
            f"batches {sorted({(r.batch_size, r.bucket_n) for r in res})}, "
            f"max err {worst:.3e}")
        say(f"[phase2] {run} host seconds by span: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(spans.items(),
                                              key=lambda kv: -kv[1])))
    for name in ("spmv", "spmm"):
        if sum(v[name] for v in launches.values()) == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"serving path")
    served_widths = {vec: sum(v[vec] for v in by_width.values())
                     for vec in ks.spmm_launches_by_width}
    if served_widths[4] == 0:
        raise AssertionError(f"the served batches never ran the vec = 4 "
                             f"spmm body: {served_widths}")
    stats = reg.stats_snapshot()
    if stats.evictions or stats.bindings_dropped:
        raise AssertionError(f"registry shed the G7 entry: {stats}")
    say(f"[phase2] ok in {time.perf_counter() - t2:.1f} s: service stats "
        f"{svc.stats}")

    # -- phase 3: timings at the G7 shapes --------------------------------
    t3 = time.perf_counter()
    x16 = ops.pad_rows(torch.from_numpy(rng.standard_normal(
        (k, 16)).astype(np.float32)).to(dev), kp)
    p = functools.partial
    with warnings.catch_warnings():     # torch.sparse's beta notices
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([rows, cols])), torch.from_numpy(vals),
            shape).to(dev).coalesce().to_sparse_csr()
    # spmv (fp32 and bf16 streams) and torch.mv on CSR in turns.
    seen, bf_seen = set(), set()
    turns = in_turns({
        "kernel": ran_plan(p(ks.spmv, idx, val, seg, x1,
                             tiles_per_chunk=tpc, **geo), seen),
        "bf16": ran_plan(p(ks.spmv, bidx, bval, bseg, x1,
                           tiles_per_chunk=tpc, **bgeo), bf_seen),
        "library": p(torch.mv, csr, x1[:k].contiguous())}, 50)
    times = {"spmv": {
        "ms": turns["kernel"], "library_ms": turns["library"],
        "plain_ms": time_ms(p(ks.spmv_plain, idx, val, seg, x1, **geo), 10),
        "plan": one_plan("timed spmv", seen, ks._card_spmv_plan(
            idx, geo["num_rows_padded"]))}}
    one_plan("timed bf16 spmv", bf_seen,
             ks._card_spmv_plan(bidx, bgeo["num_rows_padded"]))
    bf_ms = turns["bf16"]
    bounds = {"spmv": bound_ms(plan, 1)}
    bf_bound = bound_ms(bf_plan, 1)
    b, by = bounds["spmv"]
    tm = times["spmv"]
    reads = ", ".join(f"{name} " + " / ".join(f"{x:.4f}" for x in r)
                      for name, r in turns["reads"].items())
    pl = tm["plan"]
    say(f"[phase3] spmv (N=1, fp32, G7): kernel {tm['ms']:.4f} ms "
        f"({pl.lane_group} lanes a block, {len(pl.windows)} window(s), "
        f"{pl.splits} split(s)), plain {tm['plain_ms']:.4f} ms, "
        f"torch.sparse CSR {tm['library_ms']:.4f} ms "
        f"({tm['library_ms'] / tm['ms']:.2f}x the kernel's speed), bound "
        f"{b:.4f} ms ({by}); {b / tm['ms']:.3f} of the bound "
        f"({b / tm['ms'] * HBM_BYTES_PER_S / 1e9:.1f} GB/s); readings in "
        f"turns: {reads}  [{card}]")
    say(f"[phase3] spmv (N=1, bf16, G7): kernel {bf_ms:.4f} ms, bound "
        f"{bf_bound[0]:.4f} ms; {bf_bound[0] / bf_ms:.3f} of the bound  "
        f"[{card}]")
    # spmm at each served width, in turns with torch.mm on CSR.
    spmm_by_n = {}
    for n in SPMM_NS:
        xn = x16 if n == 16 else ops.pad_rows(torch.from_numpy(
            rng.standard_normal((k, n)).astype(np.float32)).to(dev), kp)
        sp = spmm_plan_on_card(xn, geo)
        tn = time_spmm(idx, val, seg, xn, geo, tpc, csr, k)
        bn, byn = bound_ms(plan, n)
        bp = bound_ms(plan, n, len(sp.windows))[0]
        spmm_by_n[str(n)] = {"ms": tn["kernel"], "library_ms": tn["library"],
                             "bound_ms": bn, "passes": len(sp.windows),
                             "bound_ms_passes": bp, "vec": sp.vec}
        reads = ", ".join(f"{name} " + " / ".join(f"{x:.4f}" for x in r)
                          for name, r in tn["reads"].items())
        say(f"[phase3] spmm (N={n}, fp32, G7): kernel {tn['kernel']:.4f} ms"
            f" (v{sp.vec}, {len(sp.windows)} pass(es)), torch.sparse CSR "
            f"{tn['library']:.4f} ms; bound {bn:.4f} ms ({byn}), with the "
            f"stream once per pass {bp:.4f} ms; {bn / tn['kernel']:.3f} of "
            f"the bound, {tn['library'] / tn['kernel']:.2f}x the speed of "
            f"CSR; readings in turns: {reads}  [{card}]")
    times["spmm"] = {
        "ms": spmm_by_n["16"]["ms"],
        "plain_ms": time_ms(p(ks.spmm_plain, idx, val, seg, x16, **geo), 5),
        "library_ms": spmm_by_n["16"]["library_ms"]}
    bounds["spmm"] = bound_ms(plan, 16)
    say(f"[phase3] spmm (N=16, fp32, G7) plain {times['spmm']['plain_ms']:.4f}"
        f" ms  [{card}]")
    say(f"[phase3] requests/s: sync {rps['sync']:.1f}, pipelined "
        f"{rps['pipelined']:.1f}  [{card}]")
    say(f"[phase3] ok in {time.perf_counter() - t3:.1f} s")

    # -- phase 4: the solvers (the second slice's main path) --------------
    t4 = time.perf_counter()
    launches["solvers"], errs["spmv_fused"], ftimes, fbounds = \
        phase_solvers(reg, svc, rows, cols, vals, shape, dev, t_run, card)
    # The fused kernel's record row is the G7 PageRank step, the slice's
    # served path at full size.
    times["spmv_fused"] = ftimes["pagerank"]
    bounds["spmv_fused"] = fbounds["pagerank"]
    say(f"[phase4] ok in {time.perf_counter() - t4:.1f} s; run so far "
        f"{time.perf_counter() - t_run:.1f} s")

    # -- phase 5: LM serving (the third slice's main path) ----------------
    t5 = time.perf_counter()
    launches["lm"], errs["flash_attention"], times["flash_attention"], \
        bounds["flash_attention"], flash_bodies = phase_lm(dev, card)
    say(f"[phase5] ok in {time.perf_counter() - t5:.1f} s; run so far "
        f"{time.perf_counter() - t_run:.1f} s")

    # -- phase 6: auto-tuned serving (the tenth slice's main path) --------
    t6 = time.perf_counter()
    launches["autotune"], by_width["autotune"], arm_spmv = phase_autotune(
        rows, cols, vals, shape, reqs, refs, dev, t_run, card)
    say(f"[phase6] ok in {time.perf_counter() - t6:.1f} s; run so far "
        f"{time.perf_counter() - t_run:.1f} s")

    # -- phase 7: verify gate, cost report, traced flush, SparseLinear ----
    t7 = time.perf_counter()
    l7, w7 = phase_analysis(reg, svc, mid, reqs, refs, opt_src, arm_spmv,
                            dev, card)
    reg.close()
    launches.update(l7)
    by_width.update(w7)
    for part in l7:
        for name in ("spmv", "spmm"):
            if part == "sparse_linear" or name == "spmm":
                if l7[part][name] == 0:
                    raise AssertionError(f"kernel {name} never launched in "
                                         f"phase 7's {part}")
    say(f"[phase7] ok in {time.perf_counter() - t7:.1f} s; run so far "
        f"{time.perf_counter() - t_run:.1f} s")

    # -- phase 8: llama4-scout MoE serving (the thirteenth slice) ---------
    # Every earlier phase's streams, registries and services go first.
    del reg, svc, op, plan, idx, val, seg, x1, x16, xn, bidx, bval, bseg, \
        csr, l7, w7
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total_mem = torch.cuda.mem_get_info()
    say(f"[phase8] card memory before the phase: {free / 1e9:.2f} GB free "
        f"of {total_mem / 1e9:.2f} GB; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    t8 = time.perf_counter()
    launches["moe"], err8, moe_bodies = phase_moe(dev, card)
    errs["flash_attention"] = max(errs["flash_attention"], err8)
    for body, rec in moe_bodies.items():
        flash_bodies[body]["launches"] += rec.pop("launches")
        flash_bodies[body].update(rec)
    say(f"[phase8] ok in {time.perf_counter() - t8:.1f} s; run so far "
        f"{time.perf_counter() - t_run:.1f} s")

    # -- phase 9: mamba2-1.3b SSM serving (the fourteenth slice) ----------
    # Phase 8's model went with its function; its cached blocks go here.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total_mem = torch.cuda.mem_get_info()
    say(f"[phase9] card memory before the phase: {free / 1e9:.2f} GB free "
        f"of {total_mem / 1e9:.2f} GB; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    t9 = time.perf_counter()
    launches["ssm"] = phase_ssm(dev, card, t_run)
    say(f"[phase9] ok in {time.perf_counter() - t9:.1f} s; run so far "
        f"{time.perf_counter() - t_run:.1f} s")

    # -- phase 10: minicpm3-4b MLA serving (the fifteenth slice) ----------
    # Phase 9's model went with its function; its cached blocks go here.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total_mem = torch.cuda.mem_get_info()
    say(f"[phase10] card memory before the phase: {free / 1e9:.2f} GB free "
        f"of {total_mem / 1e9:.2f} GB; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB  [{card}]")
    t10 = time.perf_counter()
    launches["mla"], mla_bodies = phase_mla(dev, card, t_run)
    for body, rec in mla_bodies.items():
        flash_bodies[body]["launches"] += rec.pop("launches")
        flash_bodies[body].update(rec)
    say(f"[phase10] ok in {time.perf_counter() - t10:.1f} s; run so far "
        f"{time.perf_counter() - t_run:.1f} s  [{card}]")

    # -- phase 11: whisper-base encoder-decoder serving (the seventeenth
    # slice).  Phase 10's model went with its function; its cached blocks
    # go here.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total_mem = torch.cuda.mem_get_info()
    say(f"[phase11] card memory before the phase: {free / 1e9:.2f} GB free "
        f"of {total_mem / 1e9:.2f} GB; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB  [{card}]")
    t11 = time.perf_counter()
    launches["whisper"], err11, whisper_bodies = phase_whisper(dev, card)
    errs["flash_attention"] = max(errs["flash_attention"], err11)
    for body, rec in whisper_bodies.items():
        flash_bodies[body]["launches"] += rec.pop("launches")
        flash_bodies[body].update(rec)
    say(f"[phase11] ok in {time.perf_counter() - t11:.1f} s; run so far "
        f"{time.perf_counter() - t_run:.1f} s  [{card}]")

    # -- phase 12: paligemma-3b VLM serving (the eighteenth slice).  Phase
    # 11's model went with its function; its cached blocks go here.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total_mem = torch.cuda.mem_get_info()
    say(f"[phase12] card memory before the phase: {free / 1e9:.2f} GB free "
        f"of {total_mem / 1e9:.2f} GB; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB  [{card}]")
    t12 = time.perf_counter()
    launches["vlm"], err12, vlm_bodies = phase_vlm(dev, card)
    errs["flash_attention"] = max(errs["flash_attention"], err12)
    for body, rec in vlm_bodies.items():
        flash_bodies[body]["launches"] += rec.pop("launches")
        flash_bodies[body].update(rec)
    say(f"[phase12] ok in {time.perf_counter() - t12:.1f} s; run so far "
        f"{time.perf_counter() - t_run:.1f} s  [{card}]")

    # -- phase 13: training qwen1.5-0.5b (the twentieth slice).  Phase 12's
    # model went with its function; its cached blocks go here.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total_mem = torch.cuda.mem_get_info()
    say(f"[phase13] card memory before the phase: {free / 1e9:.2f} GB free "
        f"of {total_mem / 1e9:.2f} GB; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB  [{card}]")
    t13 = time.perf_counter()
    launches["train"], errs["flash_attention_bwd"], \
        times["flash_attention_bwd"], bounds["flash_attention_bwd"], \
        train_bodies = phase_train(dev, card, t_run)
    for body, count in train_bodies.items():
        flash_bodies[body]["launches"] += count
    say(f"[phase13] ok in {time.perf_counter() - t13:.1f} s; whole run "
        f"{time.perf_counter() - t_run:.1f} s  [{card}]")
    total = {name: sum(v[name] for v in launches.values())
             for name in KERNELS}
    for name, count in total.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main paths")

    record = {"kernels": [
        dict(name=name, **KERNELS[name], launches=total[name],
             max_abs_err=errs[name], ms=times[name]["ms"],
             plain_ms=times[name]["plain_ms"], bound_ms=bounds[name][0],
             bound_by=bounds[name][1], library_ms=times[name]["library_ms"])
        for name in sorted(KERNELS)]}
    # The flash kernel's bodies: launches on the main paths, and ms, bound
    # and library ms at the served shape, at prefill_32k, at llama4's
    # served prefill, at minicpm3's, at whisper's encoder and cross
    # shapes and at paligemma's prefix-LM prefill.
    # The spmm kernel's vector widths (main-path launches, one per column
    # pass) and its time, bound and library time at each served width.
    spmm_bodies = {f"v{vec}": {"launches": sum(v[vec]
                                               for v in by_width.values())}
                   for vec in ks.spmm_launches_by_width}
    for entry in record["kernels"]:
        if entry["name"] == "flash_attention":
            entry["bodies"] = flash_bodies
        if entry["name"] == "spmm":
            entry["bodies"] = spmm_bodies
            entry["by_n"] = spmm_by_n
        if entry["name"] in ("spmv", "spmv_fused"):
            entry["plan"] = plan_record(times[entry["name"]]["plan"])
        if entry["name"] == "flash_attention_bwd":
            entry["library"] = times["flash_attention_bwd"]["library"]
    say(json.dumps(record))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
