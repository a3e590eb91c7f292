"""Drive the PyTorch/CUDA port on one GPU: the DAGPS scheduler's main path,
the serving paths of all ten model families and the training path.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and the CUDA toolkit (``nvcc``); it builds every
kernel family of ``src/repro_torch/kernels/*/csrc`` itself, one ``nvcc``
per source, all started together.  Phases, each printing its own lines:

  1. device: name, power limit, kernel build time;
  2. each scheduler kernel against its plain PyTorch version on the card,
     bitwise, at main-path shapes, with CUDA-event times for both; the scan
     also in a CUDA graph (``device_ms``, the kernel without the host's
     issue rate) and as the builder's whole call on the host's clock
     (``call_ms``: upload, launch, readback); the eligibility call, staged
     with its rounding on the card, at s13 and at a main-path wave against
     the host-rounded plain version and on an edge corpus (subnormals, one
     ulp either side, beyond FLT_MAX, +-inf, NaN), its kernel in a CUDA
     graph, the whole call beside the numpy op and the previous route on
     the host clock; the wave at s13 and on a busy
     cluster (most visits skipped), each with the length of its chain
     (visits, walked visits, pick iterations) and the time per iteration;
     the jit backend's resident scan (the window read in place from a grid
     mirror on the card) on the scan corpus and over 60 launches between
     commits and restores, each launch bitwise against ``scan_starts`` on
     the grid at launch, with its times and the bytes it uploads per call
     beside the staged call's; ``heartbeat_masks``'s cuda impl against
     numpy on s13 and the busy corpus (a superset union, the pairs and
     machines it adds counted);
  3. the scheduler's main path in exact mode: ``run_workload`` of 48
     online-mix jobs on 2048 machines through the cuda kernels, against its
     numpy-pinned twin (every JCT, the makespan and the Jain index equal to
     the last bit), with the build phase and the scan's and the wave op's
     calls and seconds on either side; then with ``build_workers=W``
     process workers on the card (W = min(8, CPU count)) in turns with a
     twin whose workers scan with numpy, and with the jit backend in turns
     with the batched one, each run making the serial run's decisions, no
     build retried, crashed, quarantined or built inline; the workers'
     CUDA contexts (start-up, memory) and their scan calls
     (``scripts/buildsvc_workers.py``); then the scheduler service:
     ``run_service_workload`` of 12 online-mix jobs on 256 machines
     against ``ClusterSim(speculate=False)`` on the card and against its
     all-numpy twin (``REPRO_KERNELS=all=numpy``; the same grants, JCTs
     and makespan by ``repr``; its pumps, agent polls, launches and the
     card ops' share of its wall), the tcp deployment shape (a serving
     thread, 16 wall-clock agents; every scan and wave launch on the
     serving thread) and the reference's chaos plan against its all-numpy
     twin (every task placed exactly once, leases reclaimed, messages
     retransmitted; placements and fault_stats equal); in each service
     path a sample of the scan and wave launches, inputs and outputs as
     the path gave them, held bitwise against the plain versions;
  4. the same population in routed mode against its numpy-pinned twin, in
     one shard and in four of 512 machines (``REPRO_SHARD_MACHINES=512``),
     and in exact mode in four shards with the numpy wave
     (``REPRO_KERNELS=match_wave=numpy``), whose eligibility calls fan out
     over the shard threads; the eligibility op's calls and ms a call on
     either side;
  5. the LM kernels (flash attention, RG-LRU scan) against their plain
     versions on the card at the serving path's shapes, plus a ragged and a
     soft-capped non-causal flash case and every prefill shape of phases
     11-13 (mixtral's GQA 32/8 at hd 128 with its window, deepseek-moe's
     MHA 16/16 at hd 128, gemma2's local and global layers 8/4 at hd 256
     with cap 50, at B=4 x 4,096; phi4-mini 24/8, granite 32/8, codeqwen
     32/32 and mixtral at hd 128, qwen2-vl 28/4 at hd 128 over 2,304
     positions and musicgen 32/32 at hd 64, at B=1 x 2,048): flash within
     2e-2 (bf16) / 2e-5 (f32), rg_lru bitwise at the prefill and at decode
     (B=4 and B=8); CUDA-event times of kernel, plain version and, for
     flash, ``scaled_dot_product_attention``, with flash's TFLOP/s, share
     of its bound and ratio to the library call (every model shape; the
     kernels line names the shape where the library leads most); rg_lru's
     device time in a CUDA graph and its share of the bound;
  6. full-width recurrentgemma-2b (random bf16 weights from a seeded
     generator on the card): ``greedy_generate`` on 4 prompts of 4,096
     tokens, 32 new tokens, against its twin pinned to the plain versions
     (``REPRO_LM_KERNELS=plain``): last-position prefill logits within
     the stated tolerance of the twin's and no further than it from the
     same weights run in float32, token agreement, launches, wall times;
  7. ``Batcher.serve`` at full width: 12 prompts of 64 tokens, 16 new
     tokens each, 8 slots, ``max_seq`` 1024 (local caches are rings);
  8. the wkv6 kernel against its plain version on the card: the rwkv6-7b
     prefill shape (B=4, S=4096, H=64, N=64, bf16), the decode shapes at
     B=4 and B=8, a ragged S=1000, an f32 case at the smoke width N=16,
     and the prefill chained over two halves against the whole run:
     y within 2e-2 (bf16) / 2e-5 (f32), final state within 1e-3; the f32
     case again at the model's scale, within twice the first-order float32
     rounding bound; each case's device time in a CUDA graph and its share
     of the bound;
  9. full-width rwkv6-7b (all 32 layers, random bf16 weights from a
     seeded generator on the card): ``greedy_generate`` on 4 prompts of
     4,096 tokens, 32 new tokens, against its plain-pinned twin, as in 6
     (with limits of its own, `LOGIT_TOL`);
 10. ``Batcher.serve`` of rwkv6-7b: 12 prompts of 64 tokens, 16 new
     tokens each, 8 slots;
 11. gemma2-2b (26 layers, all of them) and 12. deepseek-moe-16b (28
     layers, all of them, 33 GB of bf16 weights; the float32 yardstick
     casts one layer at a time): phases 6 and 7 again, with limits of
     their own, and for the MoE the number of (token, expert) routing
     choices of the prefill that differ between the two paths;
 13. the other six families at full width, each ``prefill`` of 1 x 2,048
     tokens (qwen2-vl behind 256 random patches, musicgen on 4 codebooks)
     then 8 greedy ``decode_step``s, against its plain-pinned twin and its
     float32 yardstick: phi4-mini-3.8b, granite-3-8b, codeqwen1.5-7b,
     qwen2-vl-7b, musicgen-large and mixtral-8x7b, the last cut to 16 of
     its 32 layers (93 GB of bf16 weights do not fit the card's 80; depth
     is the only cut); one ``lm:family`` line each;
 14. the backward kernels against their plain versions on the card:
     flash's dq, dk and dv (``ref.attention_bwd``, the full matrices in
     float32) at recurrentgemma-2b's training shape (B=1, S=4,096, MQA
     10/1, hd 256, window 2,048), a ragged S, gemma2's GQA 8/4 with cap 50
     (and again with q and k scaled so the scores reach the cap), MHA at hd
     128 and float32 at a narrow width, within 2e-2 (bf16) / 2e-5 (f32) of
     the plain version's max magnitude; the RG-LRU backward bitwise at
     B=1 and B=4 x 4,096 x 2,560; the WKV6 backward's six gradients (dr,
     dk, dv, dw, du, ds0) within twice ``ref.f32_bwd_error_bound`` of
     ``ref.wkv6_bwd`` at rwkv6-7b's training shape (B=1 x 4,096, 64
     heads of 64, bf16), B=4, a ragged S, S=1 and float32 at N=16, two
     calls bitwise equal; CUDA-event times of the kernels, the forwards
     (with their log-sum-exp), the plain versions and SDPA's backward,
     each with its bound;
 15. full-width recurrentgemma-2b trains (all 26 layers, seeded bf16
     weights): step 1's loss and gradients (``loss_and_grads``, B=2 x
     4,096 in two microbatches) against its plain-pinned twin (the loss
     within `LOSS_TOL`, every leaf's relative error within `GRAD_TOL`) and
     both against the same weights in float32 (`GRAD_F32_RATIO`); then 4
     AdamW steps (float32 master weights, lr 3e-4, warmup 1, total 10) on
     two alternating batches: the losses finite and step 3's below step
     1's on the same batch, the step's wall, tokens/s, peak memory,
     launches and the kernels' share of the step; then rwkv6-7b the same
     way at full width and 13 of its 32 layers (`RWKV_TRAIN_LAYERS`: the
     deepest the dry run's count puts at or below 72 GB), its gradients
     held against the twin that keeps WKV6's forward kernel and takes its
     plain backward (`GRAD_TWIN`), its loss against the plain twin's, the
     forward kernel's outputs at three layers of the pass against the
     plain forward on the same inputs (`wkv6_path_check`), its steps on
     the JAX package's AdamW schedule (warmup 100, `TRAIN_OPTS`);
 16. checkpoint resume: recurrentgemma-2b cut to 3 layers (one pattern
     triple; depth is the only cut) takes 2 steps, saves (``ckpt.save``,
     in a temporary directory, removed after), restores, and its third
     step equals a third step from the live state bit for bit;
 17. sharding and launch: the dry run (``launch/dryrun.py``: one step of
     each cell as the port's own sharded program on a cuda-typed 16 x 16
     mesh over a fake process group, rank 0's local shards on meta, in a
     child process that owns that group and sees no card) of all ten
     architectures at train_4k on the single-pod mesh, its records
     written under the output directory, its roofline rows printed and
     the cells' collective bytes by kind on its summary line; 30 jobs
     built from them (``job_from_roofline``,
     25, 50 and 100 steps) and a sweep job per architecture (its three
     trainings side by side) scheduled with dagps in exact and routed mode
     on the card, the scan,
     wave and eligibility kernels launching, each run's decisions equal to
     its numpy-pinned twin's by ``repr``; an NCCL process group of world
     size 1 (a FileStore in a temporary directory), the (1, 1) debug mesh,
     full-width recurrentgemma-2b distributed on it and
     ``compressed_psum_tree`` of a gradient tree of its shapes, each leaf
     bitwise ``dequantize(quantize_int8(g))``; the dry run's count at
     phase 15's shape beside phase 15's measured peak memory (within a
     factor of 2) and step wall (achieved TFLOP/s);
 18. the sharded programs on the same (1, 1) mesh, where every placement
     is ``Replicate()``: full-width gemma2-2b (all 26 layers, seeded bf16
     weights) distributed on it (``distribute_tree``, ``distribute_batch``)
     and called inside ``activation_sharding``: prefill of 4 x 4,096
     (last position) and ``greedy_generate`` of 32 new tokens, step 1's
     gradient pass (B=2 x 4,096, two microbatches) and 2 AdamW steps,
     each against the same call on plain tensors from the same weights:
     logits, tokens, loss, every gradient leaf and the parameters after
     the steps bitwise equal; the step's wall beside the plain step's (the
     difference is DTensor's host cost), the peak memory beside the dry
     run's count (which must put both runs' steps under 72 GB), the
     flash launches inside the kernel regions; then one gradient pass of
     recurrentgemma-2b (3 layers) and rwkv6-7b (2 layers) at full width,
     bitwise, so RG-LRU and WKV6 run forward and backward in their
     regions; then the MoE families at full width, deepseek-moe-16b at 2
     of 28 layers (a dense layer, then one of 64 experts, top-6, 2 shared)
     and mixtral-8x7b at 1 of 32 (8 experts of width 14,336): the prefill
     of 4 x 4,096 and step 1's gradient pass on plain tensors twice each,
     bitwise on repeat (the combine's fixed order), then both on the mesh,
     the dispatch and combine in their regions, bitwise against the plain
     calls, the routing's differing (token, expert) choices counted
     (``sharded:moe``, ``sharded:grads``); flash's launches in the regions
     join the kernels line.

Any failed phase exits non-zero before the result line.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists every kernel
with its launches on the paths, error, times and bound.  A fuller JSON
report (every case, per-path launches and timings) is written under the
output directory named in ``main``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
F64_OPS_PER_S = 34e12          # float64 outside the tensor cores
BF16_OPS_PER_S = 989e12        # bf16 on the tensor cores

#: the serving paths (full width): greedy_generate and Batcher.serve
LM_ARCH = "recurrentgemma_2b"
RWKV_ARCH = "rwkv6_7b"
SERVED = (LM_ARCH, RWKV_ARCH, "gemma2_2b", "deepseek_moe_16b")
#: the other families (phase 13): prefill of B=1 x 2,048 tokens (qwen2-vl:
#: behind 256 patches) and 8 greedy decode steps, at full width
FAMILIES = ("phi4_mini_3_8b", "granite3_8b", "codeqwen15_7b", "qwen2_vl_7b",
            "musicgen_large", "mixtral_8x7b")
FAMILY_B, FAMILY_S, FAMILY_STEPS = 1, 2048, 8
#: depth cuts (width is never cut): mixtral-8x7b's 32 layers hold 93 GB of
#: bf16 weights, more than the card's 80; 16 of them hold 47 GB
FAMILY_LAYERS = {"mixtral_8x7b": 16}
GEN_B, GEN_S, GEN_NEW = 4, 4096, 32
SERVE_B, SERVE_MAX_SEQ, SERVE_N, SERVE_PROMPT, SERVE_NEW = 8, 1024, 12, 64, 16
#: max and mean |logit| difference, kernel path against its plain twin, on
#: the last prefill position (logits have a standard deviation of about 1
#: in every model).  recurrentgemma-2b: bf16 keeps 8 significant bits and
#: the two paths round in other places (the flash kernel rounds its softmax
#: weights to bf16 for the tensor cores and sums in another order), which
#: after 26 residual layers moves logits by a few hundredths; a wrong mask,
#: head or state moves them by O(1).  rwkv6-7b: its bf16 rounding moves the
#: logits about 4x as far (32 layers; y is rounded to bf16 at |y| up to
#: ~600 before a per-head norm; states sum hundreds of steps): the same
#: weights run in float32 (`f32_logits`) put either bf16 path 0.53 max /
#: 0.088 mean away from it, against 0.124 / 0.020 for recurrentgemma-2b,
#: and the sound kernel path reads 0.340 / 0.0558 against its twin (H100,
#: seed 88).  Defects of bf16 rounding's own size in the kernel read 0.465
#: / 0.0846 (y read after the decay) and 0.500 / 0.0859 (y rounded toward
#: zero) (scripts/wkv6_logit_control.py).  The mean, over 262,144 logits,
#: separates them: its limit sits 1.25x above the sound reading and 1.21x
#: below the defects'.  The max, one extreme of a bf16-quantized
#: difference, gets 1.32x above the sound reading and still sits below both.
#: The other eight families (flash is their only kernel) follow one rule:
#: the mean's limit 1.25x and the max's 1.35x the highest sound kernel
#: path's reading against its twin over two seeds of weights and prompts,
#: rounded up at two significant digits (NVIDIA H100 80GB HBM3, 700 W,
#: seeds 88 / 89, max and mean: gemma2-2b 0.0820 / 0.01322 and 0.0898 /
#: 0.01338, deepseek-moe-16b 0.496 / 0.0440 and 0.902 / 0.0765, phi4-mini
#: 0.0938 / 0.01736 and 0.0938 / 0.01776, granite 0.1172 / 0.02087 and
#: 0.1094 / 0.02074, codeqwen 0.0898 / 0.01528 and 0.0938 / 0.01526,
#: qwen2-vl 0.1106 / 0.02039 and 0.1250 / 0.02213, musicgen 0.0488 /
#: 0.01087 and 0.0488 / 0.01012, mixtral (16 layers) 0.0781 / 0.01631 and
#: 0.0605 / 0.01061; a reading repeats to the last bit from run to run).
#: Gross flash defects read far above them at both seeds
#: (scripts/flash_logit_control.py --seed N): each query's own key masked
#: 2.96-17.8x the highest sound mean, the running sum not rescaled 10-42x.
#: Defects of bf16 rounding's own size read 0.76-1.28x it: P and O
#: rounded toward zero is caught at both seeds in phi4-mini and musicgen,
#: at one in granite and codeqwen; the logit scale one bf16 ulp off in
#: none; no check here separates them elsewhere.  deepseek-moe-16b reads
#: highest and moves most between seeds: its two bf16 paths route 4.8% of
#: their 2.65 million (token, expert) choices differently (`routing_diff`),
#: and a token routed elsewhere moves by O(1); its limit catches only the
#: gross defects
LOGIT_TOL = {"recurrentgemma_2b": (0.25, 0.05), "rwkv6_7b": (0.45, 0.07),
             "gemma2_2b": (0.13, 0.017), "deepseek_moe_16b": (1.3, 0.096),
             "phi4_mini_3_8b": (0.13, 0.023), "granite3_8b": (0.16, 0.027),
             "codeqwen15_7b": (0.13, 0.02), "qwen2_vl_7b": (0.17, 0.028),
             "musicgen_large": (0.066, 0.014), "mixtral_8x7b": (0.11, 0.021)}
#: either path may round differently, but the kernel path must not carry
#: the logits further from the float32 model than the plain twin does: its
#: max and mean distance to `f32_logits` at most this factor times the
#: twin's.  Sound kernel paths read up to 1.252 (musicgen-large's max at
#: seed 89: one extreme of a small bf16-quantized distance; the eight
#: families at seeds 88 and 89) and recurrentgemma-2b and rwkv6-7b within
#: 1.05; the gross flash defects of the control read 1.43 and more, and a
#: defect moving logits by O(1) shows as a factor of several
F32_DISTANCE_RATIO = 1.35

N_JOBS = 48
N_MACHINES = 2048
SEED = 88


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(tag: str, **kw) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps: int) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph and its
    replay timed with CUDA events, so the host's rate of issuing the calls
    is out of the reading (a call that allocates its outputs reuses the
    graph pool's blocks)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


class TimedCalls:
    """The placement-scan library with its staged C calls (``ps_scan_call``,
    ``ps_eligible_call``: upload, launch, results in pinned memory,
    synchronize) timed on the host clock, to be swapped in for
    ``kernel.lib``; the rest of either call (`kernel.scan_call` /
    `kernel.eligible_call` and `kernels._scan_on` /
    `kernels._machines_with_candidates_on` around it) is Python."""

    NAMES = ("ps_scan_call", "ps_eligible_call")

    def __init__(self, kernel):
        self.kernel, self.handle = kernel, kernel.lib()
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.secs = dict.fromkeys(self.NAMES, 0.0)
        for name in self.NAMES:
            setattr(self, name, self._timed(name))

    def _timed(self, name):
        fn = getattr(self.handle, name)

        def call(*args):
            t = time.perf_counter()
            err = fn(*args)
            self.secs[name] += time.perf_counter() - t
            self.calls[name] += 1
            return err
        return call

    def __getattr__(self, name):
        return getattr(self.handle, name)

    def __enter__(self):
        self.kernel.lib = lambda: self
        return self

    def __exit__(self, *exc):
        self.kernel.lib = self.kernel.LIBRARY.lib


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def s13_corpus():
    """The s13 wave corpus: m=2048 machines, n=512 candidates, d=4, seed 13."""
    import numpy as np

    from repro_torch.core.online import CandidateBatch

    m, d, n = 2048, 4, 512
    rng = np.random.default_rng(13)
    batch = CandidateBatch(
        dem=rng.uniform(0.05, 0.3, (n, d)),
        pri=rng.uniform(0.5, 2.0, n),
        srpt=rng.uniform(1.0, 300.0, n),
        grp=rng.integers(0, 2, n),
        loc=np.where(rng.random(n) < 0.3, rng.integers(0, m, n), -1),
        job=np.arange(n), tid=np.arange(n))
    avail0 = rng.uniform(0.2, 1.0, (m, d))
    return batch, avail0, np.ones(m, bool)


#: scan cases at main-path shapes (m, W, L, g tasks, largest k), as the
#: card's route launches them (the live window only, no padding): one task
#: (most of the path's calls), the long-k windows (W = 2k, k <= LONG_K =
#: 128) and a full prefetch batch
SCAN_CASES = (("modal", 4, 192, 255, 1, 64),
              ("long_k", 4, 256, 383, 8, 128),
              ("batch32", 4, 192, 255, 32, 64))


def scan_grid(m, L, g, kmax, seed, d=4):
    """A scan case's inputs: free capacity as a grid holds it (mostly room,
    with rare deep dips) of plo + L ticks, ``ceil32`` demands (g, d) with
    cells exactly at them, durations up to ``kmax``; the window
    [plo, plo + W) reads the grid's L ticks from plo = 3."""
    import numpy as np

    from repro_torch.core.engine.base import ceil32

    rng = np.random.default_rng(seed)
    plo = 3
    grid = rng.uniform(0.3, 1.0, (m, plo + L, d)).astype(np.float32)
    dips = rng.random(grid.shape) < 0.005
    grid[dips] = rng.uniform(0.0, 0.3, int(dips.sum()))
    Vs = ceil32(rng.uniform(0.01, 0.3, (g, d))).astype(np.float32)
    for _ in range(64):                 # cells exactly at a task's demand
        gi, mi, t = rng.integers(g), rng.integers(m), rng.integers(L)
        grid[mi, plo + t] = Vs[gi]
    ks = rng.integers(1, kmax + 1, g).astype(np.int32)
    ks[0] = kmax
    return grid, Vs, ks, plo


def scan_case(label, m, W, L, g, kmax, seed):
    """One scan launch against the plain version bitwise; the wrapper timed
    back to back (``ms``), the kernel alone in a CUDA graph (``device_ms``)
    and the whole call `kernels._scan_on` on the host's clock
    (``call_ms``: one pinned upload, the launch, one pinned readback), with
    the bound of this input's work."""
    import numpy as np
    import torch

    from repro_torch.core.engine import kernels as K
    from repro_torch.kernels.placement_scan import kernel, ref

    d = 4
    grid, Vs, ks, plo = scan_grid(m, L, g, kmax, seed)
    dev = torch.device("cuda")
    win_t = torch.from_numpy(np.ascontiguousarray(grid[:, plo:])).to(dev)
    Vs_t = torch.from_numpy(Vs).to(dev)
    ks_t = torch.from_numpy(ks).to(dev)
    got = kernel.scan_bitmaps(win_t, Vs_t, ks_t, L, W)
    want = ref.scan_bitmaps(win_t, Vs_t, ks_t, L, W)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"scan_bitmaps kernel != plain ({label})")
    check(bool(got.any()), f"scan case {label} has no feasible start")
    call = K._scan_on(grid, Vs, ks, plo, plo + W, True, device="cuda")
    check(call.tobytes() == K.scan_starts(grid, Vs, ks, plo, plo + W,
                                          True).tobytes(),
          f"scan call != numpy scan ({label})")
    err = float((got.int() - want.int()).abs().max())
    ms = cuda_time_ms(lambda: kernel.scan_bitmaps(win_t, Vs_t, ks_t, L, W),
                      200)
    dev_ms = graph_time_ms(
        lambda: kernel.scan_bitmaps(win_t, Vs_t, ks_t, L, W), 200)
    plain = cuda_time_ms(lambda: ref.scan_bitmaps(win_t, Vs_t, ks_t, L, W),
                         50)
    for _ in range(20):
        K._scan_on(grid, Vs, ks, plo, plo + W, True, device="cuda")
    with TimedCalls(kernel) as timed:
        t0 = time.perf_counter()
        for _ in range(500):
            K._scan_on(grid, Vs, ks, plo, plo + W, True, device="cuda")
        call_ms = (time.perf_counter() - t0) * 2.0
    c_ms = (timed.secs["ps_scan_call"] * 1e3
            / timed.calls["ps_scan_call"])
    # the work this input needs, as a running count along ticks: each
    # task's (machine, live tick) cell is d compares and one count update,
    # and each of its W starts one compare of the count with k
    n_ops = float(g * m * (L * (d + 1) + W))
    b, by = bound_ms(nbytes(win_t, Vs_t, ks_t, got), n_ops, F32_OPS_PER_S)
    say("kernel", name="scan_bitmaps", case=label,
        shape=f"m={m},W={W},L={L},g={g},kmax={kmax}", bitwise=True,
        ms=round(ms, 6), device_ms=round(dev_ms, 6),
        call_ms=round(call_ms, 6), c_call_ms=round(c_ms, 6),
        plain_ms=round(plain, 6), bound_ms=f"{b:.3e}", bound_by=by)
    return dict(case=label, shape=(m, W, L, g), max_abs_err=err, ms=ms,
                device_ms=dev_ms, call_ms=call_ms, c_call_ms=c_ms,
                plain_ms=plain, bound_ms=b, bound_by=by)


def kernel_scan(report: list) -> None:
    cases = [scan_case(*c, seed=7 + i) for i, c in enumerate(SCAN_CASES)]
    report.append(dict(
        name="scan_bitmaps", route="cuda",
        source="src/repro_torch/kernels/placement_scan/csrc/placement_scan.cu",
        replaces="src/repro/kernels/placement_scan/kernel.py:57",
        library_ms=None, cases=cases, **{k: cases[0][k] for k in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by")}))


def resident_graph_ms(dg, Vs, ks, plo, phi, reps: int = 200):
    """Device ms of one resident scan (its demands' upload and the kernel)
    from ``reps`` of them captured in one CUDA graph and replayed; None
    (with the reason) if the capture is refused."""
    import numpy as np
    import torch

    from repro_torch.kernels.placement_scan import kernel

    sp = dg.space
    m, T, d = sp.avail.shape
    g, W = len(ks), phi - plo
    L = min(T, phi + int(ks.max()) - 1) - plo
    first = plo - sp.off - dg.base
    stage = dg.stage
    off_ks = (g * d * 4 + 15) & ~15
    slot = stage.acquire(off_ks + g * 4, g * W * m)
    vs = np.ascontiguousarray(Vs, dtype=np.float32).tobytes()
    kb = np.asarray(ks, dtype=np.int32).tobytes()

    def launch():
        err = kernel.lib().ps_scan_resident(
            dg.buf.data_ptr(), dg.Tb, first, m, L, d, vs, kb, g, W, 1,
            slot.h_in_ptr, slot.d_in_ptr, 0, off_ks, slot.h_out_dev,
            None, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"resident scan launch in a graph: cudaError {err}")

    try:
        return graph_time_ms(launch, reps), None
    except (RuntimeError, SmokeFailure) as exc:
        torch.cuda.synchronize()
        return None, str(exc).splitlines()[0][:200]
    finally:
        stage.release(slot)


def kernel_resident(report: list) -> dict:
    """The jit backend's resident scan (``ps_scan_resident``: the window
    read in place from a grid mirror on the card, no synchronize): on the
    scan corpus, each launch bitwise against ``scan_starts``, timed back to
    back by CUDA events on the mirror's stream (``ms``), in a CUDA graph
    (``device_ms``) and on the host clock as the backend calls it
    (``call_ms``: launch, then wait and read every row) beside the staged
    call's ``call_ms``, with the bytes each uploads per call; then 60
    launches over 62 commits and restores, each launch's rows read only
    after the next mutations and held against ``scan_starts`` on the grid
    as it was at launch."""
    import numpy as np
    import torch

    from repro_torch.core import Space
    from repro_torch.core.engine import jit as J
    from repro_torch.core.engine import kernels as K
    from repro_torch.core.engine.base import ceil32

    scan = next(r for r in report if r["name"] == "scan_bitmaps")
    staged = {c["case"]: c for c in scan["cases"]}
    cases = []
    with K.use_device("cuda"):
        for i, (label, m, W, L, g, kmax) in enumerate(SCAN_CASES):
            grid, Vs, ks, plo = scan_grid(m, L, g, kmax, seed=7 + i)
            sp = Space(m=m, d=4, horizon=grid.shape[1])
            sp.avail[...] = grid
            dg = J.DeviceGrid(sp, "cuda")
            want = K.scan_starts(grid, Vs, ks, plo, plo + W, True)
            J.reset_profile()
            rows = dg.launch(Vs, ks, plo, plo + W, True)
            got = np.stack([rows.row(j) for j in range(g)])
            check(got.tobytes() == want.tobytes(),
                  f"resident scan != scan_starts ({label})")
            first_bytes = J.PROFILE["bytes_h2d"]

            def call():
                r = dg.launch(Vs, ks, plo, plo + W, True)
                return r.row(0)

            for _ in range(20):
                call()
            J.reset_profile()
            t0 = time.perf_counter()
            for _ in range(500):
                call()
            call_ms = (time.perf_counter() - t0) * 2.0
            per_call = J.PROFILE["bytes_h2d"] / 500
            stream = dg.stage.stream
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            for _ in range(2):              # the first pass makes the slots
                held = []
                start.record(stream)
                for _ in range(100):
                    held.append(dg.launch(Vs, ks, plo, plo + W, True))
                end.record(stream)
                end.synchronize()
                del held
            ms = start.elapsed_time(end) / 100
            dev_ms, why = resident_graph_ms(dg, Vs, ks, plo, plo + W)
            staged_bytes = m * L * 4 * 4 + g * 4 * 4 + g * 4
            c = dict(case=label, shape=(m, W, L, g), bitwise=True, ms=ms,
                     device_ms=dev_ms, call_ms=call_ms,
                     staged_call_ms=staged[label]["call_ms"],
                     bytes_per_call=per_call, first_call_bytes=first_bytes,
                     staged_bytes_per_call=staged_bytes)
            if why:
                c["device_ms_error"] = why
            say("kernel", name="scan_bitmaps", route="resident", case=label,
                shape=f"m={m},W={W},L={L},g={g},kmax={kmax}", bitwise=True,
                ms=round(ms, 6),
                device_ms=round(dev_ms, 6) if dev_ms else "not measured",
                call_ms=round(call_ms, 6),
                staged_call_ms=round(staged[label]["call_ms"], 6),
                bytes_per_call=per_call, first_call_bytes=first_bytes,
                staged_bytes_per_call=staged_bytes)
            cases.append(c)
        # commits and restores between launches, rows read late
        rng = np.random.default_rng(31)
        sp = Space(m=4, d=4, horizon=256)
        dg = J.DeviceGrid(sp, "cuda")
        snaps, pending, mutations, launches = [], None, 0, 0
        J.reset_profile()
        for round_ in range(60):
            for _ in range(2 if round_ % 3 else 1):
                if rng.random() < 0.7 or not snaps:
                    if rng.random() < 0.3:
                        snaps.append(sp.snapshot())
                    v = rng.uniform(0.05, 0.4, 4)
                    k = int(rng.integers(1, 24))
                    mm, t0 = sp.earliest_fit(v, k, int(rng.integers(0, 160)))
                    sp.commit(round_, mm, t0, k, v)
                else:
                    sp.restore(snaps.pop())
                mutations += 1
            if pending is not None:
                rows, g, want = pending
                got = np.stack([rows.row(j) for j in range(g)])
                check(got.tobytes() == want.tobytes(),
                      f"resident scan read after later mutations != "
                      f"scan_starts at launch (launch {launches})")
            g = int(rng.integers(1, 33))
            Vs = ceil32(rng.uniform(0.05, 0.5, (g, 4)))
            ks = rng.integers(1, 65, g)
            plo = int(rng.integers(0, sp.T - 40))
            phi = int(rng.integers(plo + 8, min(plo + 192, sp.T)))
            rev = bool(rng.integers(0, 2))
            pending = (dg.launch(Vs, ks, plo, phi, rev), g,
                       K.scan_starts(sp.avail, Vs, ks, plo, phi, rev))
            launches += 1
        rows, g, want = pending
        check(np.stack([rows.row(j) for j in range(g)]).tobytes()
              == want.tobytes(), "resident scan != scan_starts (last)")
        seq = dict(launches=launches, mutations=mutations,
                   bytes_per_launch=J.PROFILE["bytes_h2d"] / launches,
                   sync_cells=J.PROFILE["sync_cells"],
                   allocs=J.PROFILE["allocs"],
                   reallocs=J.PROFILE["reallocs"])
        check(mutations >= 50, "fewer than 50 mutations between launches")
        say("kernel", name="scan_bitmaps", route="resident",
            case="mutations", bitwise=True, **seq)
    scan["resident"] = dict(cases=cases, mutations=seq)
    return scan["resident"]


def heartbeat_masks_op(summary: dict) -> None:
    """``heartbeat_masks``'s cuda impl (the eligibility kernel plus the fit
    mask on the card) against the numpy op on s13 and the busy corpus: the
    union ``fits | over`` a superset of the exact union, the (candidate,
    machine) pairs and the machines it adds counted, its call timed on the
    host clock beside the numpy op's."""
    import numpy as np

    from repro_torch.core.engine import kernels as K
    from repro_torch.core.engine import packing
    from repro_torch.core.online import FUNGIBLE, RIGID

    fd, rd, gd = np.arange(4), np.asarray(RIGID), np.asarray(FUNGIBLE)
    out = {}
    for label, corpus in (("s13", s13_corpus()), ("busy", busy_corpus())):
        batch, avail, _alive = corpus
        args = (avail, batch.dem, fd, rd, gd, 0.25, True)
        fits, over = K._heartbeat_masks_on(*args, device="cuda")
        fe, oe = packing.heartbeat_masks(*args)
        union, exact = fits | over, fe | oe
        check(bool((exact <= union).all()),
              f"heartbeat_masks dropped an exactly eligible pair ({label})")
        check(bool((fe <= fits).all()),
              f"heartbeat_masks' fits dropped an exact fit ({label})")
        added = int((union & ~exact).sum())
        added_machines = int((union.any(0) & ~exact.any(0)).sum())

        def host_ms(fn, reps=50):
            fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps

        ms = host_ms(lambda: K._heartbeat_masks_on(*args, device="cuda"))
        np_ms = host_ms(lambda: packing.heartbeat_masks(*args))
        out[label] = dict(pairs=int(union.size), exact_pairs=int(exact.sum()),
                          added_pairs=added, added_machines=added_machines,
                          call_ms=ms, numpy_ms=np_ms)
        say("op", name="heartbeat_masks", impl="cuda", case=label,
            shape=f"n={union.shape[0]},m={union.shape[1]},d=4",
            superset=True, **{k: (round(v, 6) if isinstance(v, float) else v)
                              for k, v in out[label].items()})
    summary["heartbeat_masks"] = out


def eligible_case(label, avail, dem, slack, ob) -> dict:
    """One eligibility case on the card: the staged call
    (`kernels._machines_with_candidates_on`, rounding on the card) bitwise
    against the host-rounded plain version (``ref.heartbeat_eligible`` on
    the host's operands) and a superset of the exact numpy eligibility; the
    kernel alone bitwise against ``ref.heartbeat_eligible64`` on the same
    tensors.  Times: the kernel back to back (``ms``) and in a CUDA graph
    (``device_ms``); the whole call on the host clock (``call_ms``, its C
    call ``c_call_ms``; ``spaced_call_ms`` with the card idle 1 ms before
    each call while the host spins, as between the path's waves) beside
    the numpy op's
    (``numpy_ms``) and the
    previous route's (``old_call_ms``: host rounding, six uploads, the
    first kernel, readback); the first kernel alone (``old_ms``)."""
    import numpy as np
    import torch

    from repro_torch.core.engine import kernels as K
    from repro_torch.core.engine import packing
    from repro_torch.core.online import FUNGIBLE, RIGID
    from repro_torch.kernels.placement_scan import kernel, ref

    fd, rd, gd = np.arange(4), np.asarray(RIGID), np.asarray(FUNGIBLE)
    n, m = dem.shape[0], avail.shape[0]

    def call():
        return K._machines_with_candidates_on(avail, dem, fd, rd, gd, slack,
                                              ob, device="cuda")

    def old_call():
        args, _ = K._eligibility_launch_args(avail, dem, fd, rd, gd, slack,
                                             ob)
        ts = [torch.from_numpy(a).to("cuda")
              for a in (*args[:3], *args[3])]
        out = kernel.heartbeat_eligible(*ts).cpu().numpy() != 0
        return out, out.any(axis=0)

    got, got_any = call()
    args, _ = K._eligibility_launch_args(avail, dem, fd, rd, gd, slack, ob)
    ts = [torch.from_numpy(a).to("cuda") for a in (*args[:3], *args[3])]
    want = ref.heartbeat_eligible(*ts).cpu().numpy() != 0
    check(got.tobytes() == want.tobytes()
          and got_any.tobytes() == want.any(axis=0).tobytes(),
          f"staged eligibility call != host-rounded plain version ({label})")
    exact, _ = packing.machines_with_candidates(avail, dem, fd, rd, gd, slack,
                                                ob)
    check(bool((exact <= got).all()),
          f"eligibility call dropped an exactly eligible pair ({label})")
    check(bool(exact.any()), f"eligibility case {label} has no eligible pair")
    f2, r2, g2, sl = K._eligibility_dims(fd, rd, gd, slack, ob)
    masks = [torch.from_numpy(mk).to("cuda")
             for mk in K._dim_masks(4, f2, r2, g2)]
    bits = K._dim_bits(4, f2, r2, g2)
    a_t = torch.from_numpy(avail).to("cuda")
    d_t = torch.from_numpy(dem).to("cuda")
    sl = max(sl, 0.0)

    def launch():
        return kernel.eligible_launch(a_t, d_t, sl, packing.EPS, *bits)

    k_el, k_any = launch()
    p_el, p_any = ref.heartbeat_eligible64(a_t, d_t, sl, packing.EPS, *masks)
    torch.cuda.synchronize()
    check(torch.equal(k_el.t(), p_el) and torch.equal(k_any, p_any),
          f"eligibility kernel != plain version ({label})")
    err = float((k_el.t().int() - p_el.int()).abs().max())
    ms = cuda_time_ms(launch, 200)
    dev_ms = graph_time_ms(launch, 200)
    plain = cuda_time_ms(lambda: ref.heartbeat_eligible64(
        a_t, d_t, sl, packing.EPS, *masks), 50)
    old_ms = cuda_time_ms(lambda: kernel.heartbeat_eligible(*ts), 200)

    def host_ms(fn, reps=500):
        for _ in range(20):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    def spaced_ms(fn, reps=200, gap_s=1e-3):
        """ms a call when the card idles ``gap_s`` between calls while the
        host stays busy, as between the path's waves (the gap itself not
        counted; `scripts/eligible_idle.py` sweeps the gap)."""
        total = 0.0
        for _ in range(reps):
            end = time.perf_counter() + gap_s
            while time.perf_counter() < end:
                pass
            t0 = time.perf_counter()
            fn()
            total += time.perf_counter() - t0
        return total * 1e3 / reps

    with TimedCalls(kernel) as timed:
        call_ms = host_ms(call)
    c_ms = (timed.secs["ps_eligible_call"] * 1e3
            / timed.calls["ps_eligible_call"])
    spaced = spaced_ms(call)
    old_call_ms = host_ms(old_call)
    numpy_ms = host_ms(lambda: packing.machines_with_candidates(
        avail, dem, fd, rd, gd, slack, ob))
    # bytes: the float64 rows in, eligible and machine_any out; operations:
    # the rounding (1 conversion a demand value, 2 adds and 2 conversions a
    # threshold, 3 for the overbooked one) and 3 masked compares a dim per
    # pair plus the or/and
    n_ops = float(n * 4 + m * 4 * 7 + n * m * (3 * 4 + 2))
    b, by = bound_ms(nbytes(a_t, d_t, k_el, k_any), n_ops, F32_OPS_PER_S)
    say("kernel", name="heartbeat_eligible", case=label,
        shape=f"n={n},m={m},d=4", bitwise=True, ms=round(ms, 6),
        device_ms=round(dev_ms, 6), call_ms=round(call_ms, 6),
        c_call_ms=round(c_ms, 6), spaced_call_ms=round(spaced, 6),
        numpy_ms=round(numpy_ms, 6),
        old_call_ms=round(old_call_ms, 6), old_ms=round(old_ms, 6),
        plain_ms=round(plain, 6), bound_ms=f"{b:.3e}", bound_by=by)
    return dict(case=label, shape=(n, m), max_abs_err=err, ms=ms,
                device_ms=dev_ms, call_ms=call_ms, c_call_ms=c_ms,
                spaced_call_ms=spaced, numpy_ms=numpy_ms,
                old_call_ms=old_call_ms, old_ms=old_ms,
                plain_ms=plain, bound_ms=b, bound_by=by)


def kernel_eligible(report: list) -> None:
    """The eligibility call at s13 (512 candidates) and at a wave of the
    main path (32 candidates on 2048 busy machines), then the edge corpus
    (subnormals, one float32 ulp either side, beyond FLT_MAX, +-inf, NaN)
    through the staged call against the host-rounded plain version."""
    import numpy as np
    import torch

    from repro_torch.core.engine import kernels as K
    from repro_torch.core.engine import packing
    from repro_torch.core.online import FUNGIBLE, RIGID
    from repro_torch.kernels.placement_scan import ref

    cases = []
    for label, corpus in (("s13", s13_corpus()),
                          ("path_wave", busy_corpus())):
        batch, avail0, _alive = corpus
        cases.append(eligible_case(label, avail0, batch.dem, 0.25, True))
    fd, rd, gd = np.arange(4), np.asarray(RIGID), np.asarray(FUNGIBLE)
    n_edge = 0
    for seed in range(4):
        avail, dem = ref.eligibility_edge_corpus(seed, packing.EPS, m=2048,
                                                 n=64)
        for slack, ob in ((0.0, True), (0.25, True), (0.25, False)):
            with np.errstate(invalid="ignore", over="ignore"):
                got, got_any = K._machines_with_candidates_on(
                    avail, dem, fd, rd, gd, slack, ob, device="cuda")
                args, _ = K._eligibility_launch_args(avail, dem, fd, rd, gd,
                                                     slack, ob)
                exact, _ = packing.machines_with_candidates(
                    avail, dem, fd, rd, gd, slack, ob)
            ts = [torch.from_numpy(a).to("cuda")
                  for a in (*args[:3], *args[3])]
            want = ref.heartbeat_eligible(*ts).cpu().numpy() != 0
            check(got.tobytes() == want.tobytes()
                  and got_any.tobytes() == want.any(axis=0).tobytes(),
                  f"eligibility call != plain version on edge values "
                  f"(seed {seed}, slack {slack}, overbooking {ob})")
            check(bool((exact <= got).all()),
                  "eligibility call dropped an exactly eligible edge pair")
            n_edge += 1
    say("kernel", name="heartbeat_eligible", case="edge", bitwise=True,
        corpora=n_edge)
    report.append(dict(
        name="heartbeat_eligible", route="cuda",
        source="src/repro_torch/kernels/placement_scan/csrc/placement_scan.cu",
        replaces="src/repro/kernels/placement_scan/kernel.py:159",
        library_ms=None, cases=cases, edge_corpora=n_edge,
        **{k: cases[0][k] for k in ("max_abs_err", "ms", "device_ms",
                                    "plain_ms", "bound_ms", "bound_by")}))


def wave_work(args, kw, got) -> tuple[float, dict]:
    """Operations one wave's data needs, and the length of its chain, from
    the kernel's own picks.

    Replays the walk the kernel took (machines in visit order, pick
    iterations on each) and counts, per iteration, the exact eligibility
    test of every candidate still live and the score of every candidate
    in the pool, plus each pick's state update; a visit that the kernel's
    skip test passes over (``ref.visit_may_pick`` against the minimum of
    the untaken demands) needs only that test.  Taken candidates need no
    work.  Every pick the kernel made must be in the replayed pool, which
    checks the replay against the kernel.  The chain: ``visits`` (machines
    reached before the walk ended), ``walked`` (those not skipped) and
    ``iterations`` (pick iterations, the last of each visit finding
    nothing unless the bundle limit ends it).
    """
    import numpy as np

    from repro_torch.kernels.placement_scan import ref

    (avail, order, dem, pri, srpt, gidx, loc, taken0, ema, deficit, share,
     fd, rd, fg, consts) = [a.cpu().numpy() for a in args]
    rows, mach = got[3].cpu().numpy(), got[4].cpu().numpy()
    count = int(got[7])
    d, G = dem.shape[1], len(deficit)
    eps, slack, thresh = consts[0], consts[1], consts[4]
    nf, nr, ng = int(fd.sum()), int(rd.sum()), int(fg.sum())
    elig_ops = nf + nr + ng + 2                 # compares, then or/and
    fit_ops = (2 * d + 1 if kw["use_packing"] else 1) + 3 + 1  # score, argmax
    over_ops = fit_ops + 2 * ng + 4             # + overshoot penalty
    pick_ops = 6 + 2 * G + 1 + 3 * d            # ema, ledger, local/row
    taken = taken0.copy()
    deficit = deficit.copy()
    n_ops, j = 0, 0
    chain = dict(visits=0, walked=0, iterations=0)
    for mid in order[order >= 0]:
        if taken.all():
            break
        chain["visits"] += 1
        local = avail[mid].copy()
        if not ref.visit_may_pick(local, ref.demand_min(dem, taken), consts,
                                  fd, rd, fg, kw["use_overbooking"]):
            n_ops += 3 * d                      # the skip test alone
            check(j == count or mach[j] != mid,
                  "wave replay: a pick on a machine the skip test passes")
            continue
        chain["walked"] += 1
        for _ in range(kw["bundle_limit"]):
            chain["iterations"] += 1
            live = ~taken
            n_ops += int(live.sum()) * elig_ops + 2 * d   # + thresholds
            thr = local + eps
            fits = np.all((dem <= thr) | ~fd, axis=1)
            over = np.zeros_like(fits)
            if kw["use_overbooking"]:
                over = (~fits & np.all((dem <= thr) | ~rd, axis=1)
                        & np.all((dem <= local + slack + eps) | ~fg, axis=1))
            elig = (fits | over) & live
            gstar = int(np.argmax(deficit))
            forced = elig & (gidx == gstar)
            if forced.any() and deficit[gstar] >= thresh:
                elig = forced
            if not elig.any():
                break
            pool = elig & fits if (elig & fits).any() else elig
            n_ops += int((pool & fits).sum()) * fit_ops \
                + int((pool & ~fits).sum()) * over_ops
            if j == count or mach[j] != mid:
                break                           # no finite score: next machine
            i = int(rows[j])
            check(bool(pool[i]), "wave replay: a kernel pick outside the pool")
            j += 1
            n_ops += pick_ops
            taken[i] = True
            w = float(np.max(dem[i])) if kw["drf"] else 1.0
            deficit = deficit + share * w
            deficit[gidx[i]] -= w
            local = np.clip(local - dem[i], 0.0, None)
    check(j == count, f"wave replay reached {j} of {count} picks")
    return float(n_ops), chain


def busy_corpus():
    """A busy cluster as the main path's waves see it: a few dozen
    candidates (its waves hold at most 32) against 2048 machines that are
    mostly too full for them, so most visits can pick nothing."""
    import numpy as np

    from repro_torch.core.online import CandidateBatch

    m, d, n = 2048, 4, 32
    rng = np.random.default_rng(17)
    batch = CandidateBatch(
        dem=rng.uniform(0.05, 0.3, (n, d)),
        pri=rng.uniform(0.5, 2.0, n),
        srpt=rng.uniform(1.0, 300.0, n),
        grp=rng.integers(0, 2, n),
        loc=np.where(rng.random(n) < 0.3, rng.integers(0, m, n), -1),
        job=np.arange(n), tid=np.arange(n))
    avail0 = rng.uniform(0.0, 0.3, (m, d))
    return batch, avail0, np.ones(m, bool)


def wave_case(label, corpus) -> dict:
    """One wave launch against the plain version bitwise, both timed, with
    the bound of this wave's work and the length of its chain."""
    import numpy as np
    import torch

    from repro_torch.core.engine import wave as W
    from repro_torch.core.online import MatcherConfig
    from repro_torch.core.shard import ShardedMatcher
    from repro_torch.kernels.placement_scan import kernel, ref

    batch, avail0, alive = corpus
    m, d = avail0.shape
    sm = ShardedMatcher(MatcherConfig(), m, {0: 1.0, 1: 1.0}, n_shards=1,
                        capacity=float(m))
    st = W.DeviceWaveState("cuda")
    args, kw, _ = W.wave_launch_args(st, sm, batch, avail0, alive, "smoke")
    got = kernel.match_wave_walk(*args, **kw)
    want = ref.match_wave_walk(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got, want):
        a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
        check(a_np.tobytes() == b_np.tobytes(),
              f"match_wave_walk kernel != plain version ({label})")
        a64, b64 = a_np.astype(np.float64), b_np.astype(np.float64)
        same = (a64 == b64) | (np.isnan(a64) & np.isnan(b64))
        with np.errstate(invalid="ignore"):
            diff = np.where(same, 0.0, np.abs(a64 - b64))
        err = max(err, float(np.max(diff, initial=0.0)))
    count = int(got[7])
    check(count > 0, f"{label} wave picked nothing")
    ms = cuda_time_ms(lambda: kernel.match_wave_walk(*args, **kw), 20, 2)
    plain = cuda_time_ms(lambda: ref.match_wave_walk(*args, **kw), 1, 0)
    n_ops, chain = wave_work(args, kw, got)
    in_out = nbytes(*[a for a in args if torch.is_tensor(a)], *got)
    b, by = bound_ms(in_out, n_ops, F64_OPS_PER_S)
    steps = chain["walked"] + chain["iterations"]
    say("kernel", name="match_wave_walk", case=label,
        shape=f"m={m},n={len(batch)},d={d}", bitwise=True, picks=count,
        ops=int(n_ops), **chain, ms=round(ms, 6),
        ns_per_iteration=round(ms * 1e6 / max(chain["iterations"], 1), 1),
        ns_per_chain_step=round(ms * 1e6 / max(steps, 1), 1),
        plain_ms=round(plain, 6), bound_ms=f"{b:.3e}", bound_by=by)
    return dict(case=label, shape=(m, len(batch), d), picks=count,
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, chain=chain,
                ns_per_iteration=ms * 1e6 / max(chain["iterations"], 1),
                args=args, kw=kw)


def kernel_wave(report: list) -> None:
    from repro_torch.core.engine import kernels as K
    from repro_torch.core.online import MatcherConfig
    from repro_torch.core.shard import ShardedMatcher

    cases = [wave_case("s13", s13_corpus()), wave_case("busy", busy_corpus())]
    # the whole s13 wave through the dispatch layer against the numpy oracle
    batch, avail0, alive = s13_corpus()
    m = avail0.shape[0]
    cfg, shares = MatcherConfig(), {0: 1.0, 1: 1.0}
    picks = {}
    for impl in ("numpy", "cuda"):
        os.environ[K.KERNELS_ENV] = f"match_wave={impl}"
        with K.use_device("cuda"), \
                ShardedMatcher(cfg, m, shares, n_shards=1,
                               capacity=float(m)) as smx:
            av = avail0.copy()
            out = []

            def cb(gi, mm, av=av, out=out):
                out.append((gi, mm))
                av[mm] -= batch.dem[gi]

            smx.match_wave(av, alive, batch, cb)
            picks[impl] = (out, av.tobytes(), smx.matcher._ema_score,
                           smx.matcher._ema_srpt,
                           dict(smx.matcher.deficits.deficit))
    os.environ.pop(K.KERNELS_ENV, None)
    check(picks["cuda"] == picks["numpy"],
          "cuda wave decisions != numpy wave decisions (s13)")
    for c in cases:
        c.pop("args"), c.pop("kw")
    report.append(dict(
        name="match_wave_walk", route="cuda",
        source="src/repro_torch/kernels/placement_scan/csrc/placement_scan.cu",
        replaces="src/repro/kernels/placement_scan/kernel.py:102",
        library_ms=None, cases=cases, **{k: cases[0][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}))


# ----------------------------------------------------------------------
# phases 3 and 4: the main path against its numpy-pinned twin
# ----------------------------------------------------------------------

def run_path(dags, mode: str, pin: str):
    """One main-path run; ``pin`` is its ``REPRO_KERNELS`` (empty: every
    op on the card)."""
    from repro_torch.core.engine import kernels as K
    from repro_torch.kernels.placement_scan import kernel
    from repro_torch.sim import run_workload

    pin_numpy = pin == "all=numpy"
    if pin:
        os.environ[K.KERNELS_ENV] = pin
    else:
        os.environ.pop(K.KERNELS_ENV, None)
    K.reset_profile()
    kernel.reset_launches()
    t0 = time.perf_counter()
    try:
        with TimedCalls(kernel) as timed:
            res = run_workload(dags, "dagps", n_machines=N_MACHINES,
                               interarrival=0.5, seed=SEED, build_machines=4,
                               matcher_mode=mode, profile=True,
                               device="cuda")
    finally:
        os.environ.pop(K.KERNELS_ENV, None)
    wall = time.perf_counter() - t0
    prof = K.profile_snapshot()
    if not pin_numpy:
        prof["scan.cuda.c_call"] = (timed.calls["ps_scan_call"],
                                    timed.secs["ps_scan_call"])
        prof["machines_with_candidates.cuda.c_call"] = (
            timed.calls["ps_eligible_call"], timed.secs["ps_eligible_call"])
    return res, wall, prof, kernel.launch_counts()


def scan_shapes(summary: dict) -> dict:
    """Scan launches per (m, W, L, g) shape over both main-path runs (the
    ``scan.cuda.shape.*`` tallies of `kernels._scan_on`: the live window,
    unpadded)."""
    out: dict = {}
    for run in summary.values():
        for key, (calls, _secs) in run.get("profile", {}).items():
            if key.startswith("scan.cuda.shape."):
                m, W, L, g = (int(p[1:]) for p in key.split(".")[3:])
                out[(m, W, L, g)] = out.get((m, W, L, g), 0) + calls
    return out


def shape_class(m, W, L, g) -> tuple:
    """A launch shape on the bucket ladder of W and task count, the key
    that matches a path's launches to the nearest `SCAN_CASES` entry."""
    from repro_torch.core.engine import kernels as K
    return (m, K.bucket(W), K.pad8(g))


def decisions(res) -> dict:
    return {"jcts": {str(j.job_id): repr(j.jct) for j in res.jobs},
            "makespan": repr(res.makespan),
            "jain_60": repr(res.jain_index(60.0, {0: 1.0}))}


#: the order of the main path's runs: through the kernels, then twice
#: through the numpy twin, then the kernels again, so that warm-up and
#: drift of the host (the first run of a process builds seconds slower)
#: fall on both sides alike; each side reads the mean of its two runs
PATH_TURNS = ("cuda", "numpy", "numpy", "cuda")


def main_path(label: str, mode: str, dags, need: tuple, summary: dict,
              pin: str = "", shard_machines: int | None = None,
              rebuild: bool = False) -> dict:
    """``label``'s runs in turns: ``mode`` with the kernels (``pin``: a
    ``REPRO_KERNELS`` pin of some ops to numpy) against the all-numpy twin,
    at ``shard_machines`` machines a shard (``REPRO_SHARD_MACHINES``, for
    these runs only; default: one shard); ``rebuild`` clears the schedule
    cache before every run, so that every run builds every schedule."""
    from repro_torch.core.shard import SHARD_MACHINES_ENV
    from repro_torch.sim import clear_schedule_cache

    runs: dict = {"cuda": [], "numpy": []}
    if shard_machines is not None:
        os.environ[SHARD_MACHINES_ENV] = str(shard_machines)
    try:
        for side in PATH_TURNS:
            if rebuild:
                clear_schedule_cache()
            runs[side].append(run_path(
                dags, mode, pin if side == "cuda" else "all=numpy"))
    finally:
        os.environ.pop(SHARD_MACHINES_ENV, None)
    for res, _wall, prof, _launches in runs["cuda"]:
        check(len(res.jobs) == len(dags),
              f"{label}: {len(res.jobs)} of {len(dags)} jobs completed")
        bad = [k for k in prof if k.endswith(".demoted")]
        check(not bad, f"{label}: demotion: {bad}")
        for key in need:
            check(prof.get(key, (0, 0.0))[0] > 0, f"{label}: {key} never ran")
    for _res, _wall, ref_prof, _launches in runs["numpy"]:
        check(not any(k.split(".")[1] in ("cuda", "torch") for k in ref_prof
                      if k.count(".") >= 1),
              f"{label}: the numpy-pinned twin dispatched a kernel")
    theirs = decisions(runs["numpy"][0][0])
    for side in ("cuda", "numpy"):
        for r in runs[side]:
            check(decisions(r[0]) == theirs,
                  f"{label}: results differ from the numpy twin")
    launches = runs["cuda"][0][3]
    check(runs["cuda"][1][3] == launches,
          f"{label}: the two kernel runs launched differently")
    res, _wall, prof, _launches = runs["cuda"][0]
    mine = decisions(res)

    def mean(side, f):
        return sum(f(*r) for r in runs[side]) / len(runs[side])

    def op(side, key):
        return (mean(side, lambda _r, _w, p, _l: p.get(key, (0, 0.0))[0]),
                mean(side, lambda _r, _w, p, _l: p.get(key, (0, 0.0))[1]))

    def phase(name):
        return {side: mean(side, lambda r, _w, _p, _l:
                           (r.phase_times or {}).get(name, 0.0))
                for side in runs}
    wall = {side: mean(side, lambda _r, w, _p, _l: w) for side in runs}
    build, match = phase("build"), phase("match")
    scans, np_scans = op("cuda", "scan.cuda"), op("numpy", "scan.numpy")
    c_call = op("cuda", "scan.cuda.c_call")
    wave_s = {"cuda": op("cuda", "match_wave.cuda")[1],
              "numpy": op("numpy", "match_wave.numpy")[1]}
    waves = res.shard_stats["waves"]
    pt = {k: round(v, 4) for k, v in (res.phase_times or {}).items()}
    secs = {k: round(v[1], 4) for k, v in prof.items() if v[1] > 0}
    np_secs = {k: round(v[1], 4) for k, v in runs["numpy"][0][2].items()
               if v[1] > 0}
    elig = op("cuda", "machines_with_candidates.cuda")
    elig_c = op("cuda", "machines_with_candidates.cuda.c_call")
    np_elig = op("numpy", "machines_with_candidates.numpy")
    say(f"path:{label}", mode=mode, pin=pin or "none",
        n_shards=res.shard_stats["n_shards"], jobs=len(res.jobs),
        identical_to_numpy=True,
        turns=",".join(PATH_TURNS), wall_s=round(wall["cuda"], 3),
        numpy_wall_s=round(wall["numpy"], 3),
        build_s=round(build["cuda"], 3),
        numpy_build_s=round(build["numpy"], 3),
        match_s=round(match["cuda"], 3),
        numpy_match_s=round(match["numpy"], 3),
        scan_calls=int(scans[0]), scan_cuda_s=round(scans[1], 4),
        scan_cuda_ms_per_call=round(scans[1] * 1e3 / max(scans[0], 1), 6),
        scan_c_call_ms_per_call=round(c_call[1] * 1e3 / max(scans[0], 1), 6),
        scan_numpy_calls=int(np_scans[0]), scan_numpy_s=round(np_scans[1], 4),
        scan_numpy_ms_per_call=round(
            np_scans[1] * 1e3 / max(np_scans[0], 1), 6),
        elig_calls=int(elig[0]), elig_cuda_s=round(elig[1], 4),
        elig_cuda_ms_per_call=round(elig[1] * 1e3 / max(elig[0], 1), 6),
        elig_c_call_ms_per_call=round(elig_c[1] * 1e3 / max(elig[0], 1), 6),
        elig_numpy_calls=int(np_elig[0]), elig_numpy_s=round(np_elig[1], 4),
        elig_numpy_ms_per_call=round(
            np_elig[1] * 1e3 / max(np_elig[0], 1), 6),
        waves=waves, match_wave_cuda_s=round(wave_s["cuda"], 4),
        match_wave_numpy_s=round(wave_s["numpy"], 4),
        walls=json.dumps({side: [round(r[1], 3) for r in runs[side]]
                          for side in runs}, separators=(",", ":")),
        phases=json.dumps(pt, separators=(",", ":")),
        op_s=json.dumps(secs, separators=(",", ":")),
        numpy_op_s=json.dumps(np_secs, separators=(",", ":")),
        makespan=mine["makespan"], jain_60=mine["jain_60"])
    summary[label] = dict(
        mode=mode, pin=pin, n_shards=res.shard_stats["n_shards"],
        turns=PATH_TURNS, elig_calls=elig[0], elig_s=elig[1],
        elig_c_call_s=elig_c[1], elig_numpy_calls=np_elig[0],
        elig_numpy_s=np_elig[1], wall_s=wall["cuda"], numpy_wall_s=wall["numpy"],
        build_s=build["cuda"], numpy_build_s=build["numpy"],
        phase_times={side: [r[0].phase_times for r in runs[side]]
                     for side in runs},
        scan_calls=scans[0], scan_s=scans[1], scan_c_call_s=c_call[1],
        scan_numpy_calls=np_scans[0], scan_numpy_s=np_scans[1],
        waves=waves, launches=launches, match_wave_s=wave_s,
        walls={side: [r[1] for r in runs[side]] for side in runs},
        decisions=mine,
        profile={k: list(v) for k, v in prof.items()},
        numpy_profile={k: list(v) for k, v in runs["numpy"][0][2].items()},
        makespan=mine["makespan"], jain_60=mine["jain_60"])
    return launches


def build_workers_path(dags, summary: dict) -> None:
    """The exact path with ``build_workers=W`` process workers on the card
    (W = min(8, the CPU count)), in turns with a twin whose workers scan
    with numpy (``REPRO_KERNELS=scan=numpy``, carried to the workers by the
    pool's initializer): workers, twin, twin, workers.  Every run makes the
    serial run's decisions (phase 3's ``exact``), with no retry, crash,
    inline build or quarantine.  Then the workers' CUDA contexts and their
    scan calls (``scripts/buildsvc_workers.py``)."""
    from repro_torch.core import buildsvc
    from repro_torch.core.engine import kernels as K
    from repro_torch.sim import clear_schedule_cache, run_workload

    W = min(8, os.cpu_count() or 1)
    method = buildsvc._default_mp_context().get_start_method()
    serial = summary["exact"]
    runs = {"cuda": [], "numpy": []}
    os.environ[buildsvc.MODE_ENV] = "process"
    try:
        for side in PATH_TURNS:
            if side == "numpy":
                os.environ[K.KERNELS_ENV] = "scan=numpy"
            else:
                os.environ.pop(K.KERNELS_ENV, None)
            clear_schedule_cache()
            t0 = time.perf_counter()
            res = run_workload(dags, "dagps", n_machines=N_MACHINES,
                               interarrival=0.5, seed=SEED, build_machines=4,
                               build_workers=W, profile=True, device="cuda")
            runs[side].append((res, time.perf_counter() - t0))
    finally:
        os.environ.pop(buildsvc.MODE_ENV, None)
        os.environ.pop(K.KERNELS_ENV, None)
    for side in runs:
        for res, _wall in runs[side]:
            check(decisions(res) == serial["decisions"],
                  f"build workers ({side}): decisions differ from the "
                  "serial run")
            bad = {k: v for k, v in res.fault_stats["build"].items()
                   if k in ("retries", "worker_crashes", "inline_fallbacks",
                            "quarantined_digests") and v}
            check(not bad, f"build workers ({side}): {bad}")

    def mean(side, f):
        return sum(f(r) for r in runs[side]) / len(runs[side])

    wall = {s: mean(s, lambda r: r[1]) for s in runs}
    build = {s: mean(s, lambda r: r[0].phase_times["build"]) for s in runs}
    sys.path.insert(0, ROOT)
    from scripts import buildsvc_workers

    probe = buildsvc_workers.probe(W, calls=500)
    tog, alone = probe["together"], probe["alone"]
    say("path:exact_build_workers", mode="exact", workers=W,
        start_method=method, turns=",".join(PATH_TURNS),
        identical_to_serial=True, retries=0, worker_crashes=0,
        inline_fallbacks=0, quarantined_digests=0,
        wall_s=round(wall["cuda"], 3), twin_wall_s=round(wall["numpy"], 3),
        build_s=round(build["cuda"], 3),
        twin_build_s=round(build["numpy"], 3),
        serial_wall_s=round(serial["wall_s"], 3),
        serial_build_s=round(serial["build_s"], 3),
        walls=json.dumps({s: [round(r[1], 3) for r in runs[s]]
                          for s in runs}, separators=(",", ":")),
        context_mb_per_worker=round(tog["context_mb_per_worker"], 1),
        smi_mb_per_worker=tog["smi_mb_per_worker"],
        used_mb_seen_in_worker=json.dumps(
            [round(x, 1) for x in tog["used_mb_seen_in_worker"]],
            separators=(",", ":")),
        worker_ready_s=json.dumps([round(x, 3) for x in tog["ready_s"]],
                                  separators=(",", ":")),
        worker_start_s=json.dumps([round(x, 3) for x in tog["start_s"]],
                                  separators=(",", ":")),
        scan_call_ms_in_workers=json.dumps(
            [round(x, 6) for x in tog["scan_call_ms"]],
            separators=(",", ":")),
        scan_call_ms_alone=round(alone["scan_call_ms"][0], 6),
        makespan=serial["makespan"])
    summary["exact_build_workers"] = dict(
        workers=W, start_method=method, turns=PATH_TURNS, wall_s=wall,
        build_s=build, walls={s: [r[1] for r in runs[s]] for s in runs},
        phase_times={s: [r[0].phase_times for r in runs[s]] for s in runs},
        fault_stats={s: [r[0].fault_stats["build"] for r in runs[s]]
                     for s in runs},
        workers_probe=probe)


def jit_path(dags, summary: dict) -> None:
    """The exact path with ``placement_backend="jit"`` (the resident
    mirror) in turns with the batched backend: jit, batched, batched, jit,
    every build rebuilt; decision-identical.  Scan calls through the
    dispatch layer (row 0 and small batches), resident launches, batches
    below the floor, mirror allocations and regrowths, bytes uploaded."""
    from repro_torch.core.engine import jit as J
    from repro_torch.core.engine import kernels as K
    from repro_torch.kernels.placement_scan import kernel
    from repro_torch.sim import clear_schedule_cache, run_workload

    runs = {"jit": [], "batched": []}
    for side in ("jit", "batched", "batched", "jit"):
        clear_schedule_cache()
        K.reset_profile()
        J.reset_profile()
        t0 = time.perf_counter()
        res = run_workload(dags, "dagps", n_machines=N_MACHINES,
                           interarrival=0.5, seed=SEED, build_machines=4,
                           placement_backend=side, profile=True,
                           device="cuda")
        runs[side].append((res, time.perf_counter() - t0,
                           K.profile_snapshot(), dict(J.PROFILE)))
    serial = summary["exact"]["decisions"]
    for side in runs:
        for r in runs[side]:
            check(decisions(r[0]) == serial,
                  f"jit path ({side}): decisions differ from the exact run")
    for r in runs["jit"]:
        check(r[3]["device_calls"] > 0, "jit path: no resident launch")
        check(not any(k.startswith("scan.numpy") for k in r[2]),
              "jit path: a scan ran on numpy")

    def mean(side, f):
        return sum(f(r) for r in runs[side]) / len(runs[side])

    wall = {s: mean(s, lambda r: r[1]) for s in runs}
    build = {s: mean(s, lambda r: r[0].phase_times["build"]) for s in runs}
    jp = {k: mean("jit", lambda r, k=k: r[3][k]) for k in J.PROFILE}
    scans = {s: (mean(s, lambda r: r[2].get("scan.cuda", (0, 0.0))[0]),
                 mean(s, lambda r: r[2].get("scan.cuda", (0, 0.0))[1]))
             for s in runs}
    say("path:exact_jit", mode="exact", backend="jit",
        turns="jit,batched,batched,jit", identical_to_batched=True,
        wall_s=round(wall["jit"], 3), batched_wall_s=round(wall["batched"], 3),
        build_s=round(build["jit"], 3),
        batched_build_s=round(build["batched"], 3),
        scan_calls=int(scans["jit"][0]),
        scan_call_ms=round(scans["jit"][1] * 1e3 / max(scans["jit"][0], 1),
                           6),
        batched_scan_calls=int(scans["batched"][0]),
        batched_scan_call_ms=round(
            scans["batched"][1] * 1e3 / max(scans["batched"][0], 1), 6),
        device_launches=int(jp["device_calls"]),
        launch_ms=round(jp["scan_seconds"] * 1e3
                        / max(jp["device_calls"], 1), 6),
        fallback_calls=int(jp["fallback_calls"]),
        mirror_allocs=int(jp["allocs"]), mirror_reallocs=int(jp["reallocs"]),
        resident_slots=kernel.resident_stage("cuda").slots,
        bytes_h2d=int(jp["bytes_h2d"]),
        bytes_per_launch=round(jp["bytes_h2d"] / max(jp["device_calls"], 1),
                               1),
        walls=json.dumps({s: [round(r[1], 3) for r in runs[s]]
                          for s in runs}, separators=(",", ":")))
    summary["exact_jit"] = dict(
        wall_s=wall, build_s=build, jit_profile=jp, scan_calls=scans,
        walls={s: [r[1] for r in runs[s]] for s in runs},
        phase_times={s: [r[0].phase_times for r in runs[s]] for s in runs})


# ----------------------------------------------------------------------
# phase 3, continued: the scheduler service (svc/)
# ----------------------------------------------------------------------

#: path:service: the service's cost is its Python control plane (every
#: pump polls every agent; heartbeats bring about M x makespan / period
#: pumps), about M^2 in all, so it runs at 256 machines, not 2048
SVC_JOBS, SVC_MACHINES = 12, 256
#: path:service-tcp: wall-clock agents on real sockets, and the bound on
#: the wait for their jobs
SVC_TCP_AGENTS, SVC_TCP_JOBS, SVC_TCP_DEADLINE_S = 16, 4, 180.0
#: path:service-chaos: tests/test_service.py's chaos plan and workload
SVC_CHAOS_MACHINES = 10
SVC_CHAOS_PLAN = ("seed=5;comm_send:drop@0.08;comm_send:dup@0.08;"
                  "comm_send:delay@0.05,delay=0.5;"
                  "agent:crash@1.0,machine=3,count=1;"
                  "agent:partition@0.03,delay=4.0;heartbeat:drop@0.08")


class LaunchThreads:
    """The placement-scan library's launch counts, also by the name of the
    launching thread, for the duration of the block (``kernel._count``
    still adds one to ``LAUNCHES`` per launch)."""

    def __init__(self, kernel):
        self.kernel, self.by_thread = kernel, {}

    def __enter__(self):
        import threading

        count = self._count = self.kernel._count

        def counted(name):
            key = (threading.current_thread().name, name)
            self.by_thread[key] = self.by_thread.get(key, 0) + 1
            count(name)
        self.kernel._count = counted
        return self

    def __exit__(self, *exc):
        self.kernel._count = self._count

    def of(self, thread: str) -> dict:
        return {k: n for (t, k), n in self.by_thread.items() if t == thread}


#: which of a path's launches `HeldLaunches` keeps, per op: the first
#: ``first``, then every ``every``-th, at most ``cap`` in all
HELD = {"scan": dict(first=8, every=64, cap=48),
        "wave": dict(first=8, every=16, cap=32)}


class HeldLaunches:
    """A sample of the scan and wave launches made in the block, each with
    the inputs the path gave it and the outputs it returned (copies), for
    `hold` to check against the plain versions afterwards: the kernels at
    the shapes and on the data of the service paths, whichever thread
    launched them."""

    def __init__(self, kernel):
        import threading

        self.kernel, self.lock = kernel, threading.Lock()
        self.seen = {"scan": 0, "wave": 0}
        self.taken = {"scan": 0, "wave": 0}
        self.kept: dict = {"scan": [], "wave": []}

    def _keep(self, op: str) -> bool:
        rule = HELD[op]
        with self.lock:
            i = self.seen[op]
            self.seen[op] += 1
            if (i < rule["first"] or i % rule["every"] == 0) \
                    and self.taken[op] < rule["cap"]:
                self.taken[op] += 1
                return True
        return False

    def _add(self, op: str, rec) -> None:
        with self.lock:
            self.kept[op].append(rec)

    def __enter__(self):
        import numpy as np

        scan, wave = self.scan, self.wave = (self.kernel.scan_call,
                                             self.kernel.match_wave_walk)

        def scan_call(avail, plo, L, Vs, ks, W, reverse=False, **kw):
            out = scan(avail, plo, L, Vs, ks, W, reverse, **kw)
            if self._keep("scan"):
                self._add("scan", (
                    np.array(avail[:, plo:plo + L], np.float32),
                    np.array(Vs, np.float32), np.array(ks, np.int32),
                    int(W), bool(reverse), out.copy()))
            return out

        def match_wave_walk(*args, **kw):
            out = wave(*args, **kw)
            if self._keep("wave"):
                self._add("wave", ([a.clone() for a in args], dict(kw),
                                   [o.clone() for o in out]))
            return out
        self.kernel.scan_call = scan_call
        self.kernel.match_wave_walk = match_wave_walk
        return self

    def __exit__(self, *exc):
        self.kernel.scan_call = self.scan
        self.kernel.match_wave_walk = self.wave

    def hold(self, label: str) -> dict:
        """Every kept launch against the plain version on the card,
        bitwise: the scan's over its live window padded as the plain
        route pads it (``kernels._scan_on``), the wave's on the very
        tensors it was given."""
        import numpy as np
        import torch

        from repro_torch.kernels.placement_scan import ref

        dev = torch.device("cuda")
        check(self.taken == {op: len(v) for op, v in self.kept.items()},
              f"{label}: a kept launch was not recorded")
        for win, Vs, ks, W, reverse, got in self.kept["scan"]:
            m, L, d = win.shape
            pad = torch.full((m, max(L, W + int(ks.max())), d), -1.0,
                             dtype=torch.float32, device=dev)
            pad[:, :L] = torch.from_numpy(win).to(dev)
            want = ref.scan_bitmaps(pad, torch.from_numpy(Vs).to(dev),
                                    torch.from_numpy(ks).to(dev), L, W)
            good = want.cpu().numpy() != 0
            if reverse:
                good = good[:, ::-1, :]
            check(np.ascontiguousarray(good).reshape(len(ks), W * m)
                  .tobytes() == got.tobytes(),
                  f"{label}: scan launch (m={m}, W={W}, L={L}, g={len(ks)})"
                  " != plain version")
        shapes = set()
        for args, kw, got in self.kept["wave"]:
            want = ref.match_wave_walk(*args, **kw)
            m, n = args[0].shape[0], args[2].shape[0]
            shapes.add((m, n))
            for a, b in zip(got, want):
                check(a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes(),
                      f"{label}: wave launch (m={m}, n={n}) != plain "
                      "version")
        return dict(held_scans=len(self.kept["scan"]),
                    held_waves=len(self.kept["wave"]),
                    held_wave_machines=sorted({m for m, _ in shapes}),
                    held_wave_max_n=max((n for _, n in shapes), default=0))


def pinned_numpy(run, need=("scan.numpy", "match_wave.numpy")):
    """``run()`` with every op pinned to numpy (``REPRO_KERNELS=all=numpy``)
    and the schedule cache cleared, so that its builds scan with numpy too;
    checks that no op dispatched to the card or to torch, and that each op
    of ``need`` ran."""
    from repro_torch.core.engine import kernels as K
    from repro_torch.sim import clear_schedule_cache

    clear_schedule_cache()
    K.reset_profile()
    os.environ[K.KERNELS_ENV] = "all=numpy"
    t0 = time.perf_counter()
    try:
        res = run()
    finally:
        os.environ.pop(K.KERNELS_ENV, None)
    wall = time.perf_counter() - t0
    prof = K.profile_snapshot()
    check(not any(k.split(".")[1] in ("cuda", "torch") for k in prof
                  if k.count(".") >= 1),
          "the numpy-pinned twin dispatched a kernel")
    check(all(prof.get(key, (0, 0.0))[0] > 0 for key in need),
          f"the numpy-pinned twin ran none of {need}")
    return res, wall


def same_decisions(label: str, a, b, what: str) -> None:
    """Two runs' grants, JCTs and makespan equal by ``repr``."""
    check(a.placements == b.placements,
          f"{label}: placements differ from the {what}'s")
    check(sorted((j.job_id, repr(j.jct)) for j in a.jobs)
          == sorted((j.job_id, repr(j.jct)) for j in b.jobs),
          f"{label}: JCTs differ from the {what}'s")
    check(repr(a.makespan) == repr(b.makespan),
          f"{label}: makespan differs from the {what}'s")


def service_path(summary: dict) -> dict:
    """``path:service``: `run_service_workload` (an inproc service, one
    virtual agent per machine, virtual time) of 12 online-mix jobs on 256
    machines on the card, against ``ClusterSim(speculate=False)`` of the
    same arrivals on the card and against its all-numpy twin: the same
    grants, JCTs and makespan by ``repr``, every task placed once, no
    lease reclaimed; a sample of the service's scan and wave launches held
    against the plain versions.  Its pumps and agent polls, the scan's and
    the wave's launches and dispatch seconds inside the service run, and
    the walls (``scripts/service_profile.py``'s `measure`)."""
    from repro_torch.kernels.placement_scan import kernel
    from scripts import service_profile

    held = HeldLaunches(kernel)
    m = service_profile.measure("cuda", SVC_MACHINES, SVC_JOBS,
                                around=lambda: held)
    svc, sim, wall, sim_wall = m["svc"], m["sim"], m["wall_s"], m["sim_wall_s"]
    arrivals, launches, prof = m["arrivals"], m["launches"], m["ops"]
    for name in ("scan_bitmaps", "match_wave_walk"):
        check(launches[name] > 0, f"service: {name} never launched")
    check(len(svc.jobs) == SVC_JOBS,
          f"service: {len(svc.jobs)} of {SVC_JOBS} jobs completed")
    same_decisions("service", svc, sim, "simulator")
    twin, twin_wall = pinned_numpy(lambda: service_profile.simulate(
        arrivals, "cuda", SVC_MACHINES))
    same_decisions("service", svc, twin, "all-numpy simulator")
    kept = held.hold("service")
    check(all(v == 1 for v in svc.effective.values())
          and len(svc.effective) == sum(a[1].n for a in arrivals),
          "service: a task was not placed exactly once")
    fs = svc.fault_stats
    check(fs["service"]["lease_reclaims"] == 0,
          "service: a lease was reclaimed on a healthy run")
    scan = prof.get("scan.cuda", (0, 0.0))
    wave = prof.get("match_wave.cuda", (0, 0.0))
    check(not any(k.endswith(".demoted") for k in prof), "service: demotion")
    check(not any(k.split(".")[1] in ("numpy", "torch") for k in prof
                  if k.startswith(("scan.", "match_wave."))),
          "service: a scan or wave ran off the card")
    card_s = scan[1] + wave[1]
    say("path:service", machines=SVC_MACHINES, jobs=SVC_JOBS,
        identical_to_sim=True, identical_to_numpy_sim=True,
        wall_s=round(wall, 3), sim_wall_s=round(sim_wall, 3),
        numpy_sim_wall_s=round(twin_wall, 3),
        wall_over_sim=round(wall / sim_wall, 3), pumps=m["pumps"],
        agent_polls=m["agent_polls"],
        scan_launches=launches["scan_bitmaps"],
        wave_launches=launches["match_wave_walk"],
        scan_calls=scan[0], scan_cuda_s=round(scan[1], 4),
        wave_calls=wave[0], match_wave_cuda_s=round(wave[1], 4),
        card_ops_share=round(card_s / wall, 4),
        host_s=round(wall - card_s, 3),
        placements=len(svc.placements),
        beats=fs["heartbeat"]["beats"], comm_sent=fs["comm"]["sent"],
        makespan=repr(svc.makespan), **kept)
    summary["service"] = dict(
        machines=SVC_MACHINES, jobs=SVC_JOBS, wall_s=wall,
        sim_wall_s=sim_wall, numpy_sim_wall_s=twin_wall, held=kept,
        pumps=m["pumps"], agent_polls=m["agent_polls"],
        launches=launches, profile={k: list(v) for k, v in prof.items()},
        fault_stats=fs, makespan=repr(svc.makespan),
        jcts={str(j.job_id): repr(j.jct) for j in svc.jobs})
    return launches


def service_tcp_path(summary: dict) -> dict:
    """``path:service-tcp``: the deployment shape on the card.  The
    scheduler served from its own thread on a tcp listener, 16 wall-clock
    `Agent` threads (period 0.2 s, leases compressed by 0.0005), a `Client`
    submitting 4 production jobs: every job done within the deadline, every
    task placed once, the stats fetched over the wire, the scan's and the
    wave's launches made by the serving thread, and a sample of them held
    against the plain versions."""
    from repro_torch.core import FaultPlan, faults
    from repro_torch.kernels.placement_scan import kernel
    from repro_torch.sim import make_workload
    from repro_torch.sim.cluster import scheme
    from repro_torch.svc import Client, ServiceConfig, connect
    from repro_torch.svc.agent import Agent
    from repro_torch.svc.scheduler import SchedulerCore, SchedulerService

    dags = make_workload("production", SVC_TCP_JOBS, seed=21)
    n_tasks = sum(d.n for d in dags)
    kernel.reset_launches()
    with faults.scope(FaultPlan()), LaunchThreads(kernel) as threads, \
            HeldLaunches(kernel) as held:
        core = SchedulerCore(ServiceConfig(
            n_machines=SVC_TCP_AGENTS, seed=0, heartbeat_period=0.2,
            groups=(0,), device="cuda"), scheme("dagps"))
        svc = SchedulerService(core, "tcp://127.0.0.1:0")
        agents, client = [], None
        t0 = time.perf_counter()
        try:
            svc.serve_in_thread(poll_interval=0.005)
            for m in range(SVC_TCP_AGENTS):
                agents.append(Agent(svc.addr, m, period=0.2,
                                    time_scale=0.0005))
                agents[-1].start()
            client = Client(connect(svc.addr))
            handles = [client.submit(dag, t=0.0) for dag in dags]
            deadline = time.monotonic() + SVC_TCP_DEADLINE_S
            while client.pending and time.monotonic() < deadline:
                client.poll()
                time.sleep(0.01)
            wall = time.perf_counter() - t0
            check(client.pending == 0,
                  f"service-tcp: {client.pending} of {len(dags)} jobs not "
                  f"done within {SVC_TCP_DEADLINE_S} s")
            fs = client.stats(timeout=30.0)["fault_stats"]
        finally:
            for ag in agents:
                ag.stop()
            if client is not None:
                client.ch.close()
            svc.close()
    launches = kernel.launch_counts()
    serving = threads.of("repro-sched")
    check(all(h.result is not None for h in handles),
          "service-tcp: a job has no result")
    check(fs["service"]["completions"] == n_tasks,
          f"service-tcp: {fs['service']['completions']} of {n_tasks} tasks "
          "completed (stats over the wire)")
    check(all(v == 1 for v in core.effective.values())
          and len(core.effective) == n_tasks,
          "service-tcp: a task was not placed exactly once")
    for name in ("scan_bitmaps", "match_wave_walk"):
        check(serving.get(name, 0) > 0,
              f"service-tcp: the serving thread launched no {name}")
    check(serving == {k: v for k, v in launches.items() if v},
          f"service-tcp: launches off the serving thread: "
          f"{threads.by_thread}")
    kept = held.hold("service-tcp")
    say("path:service-tcp", agents=SVC_TCP_AGENTS, jobs=len(dags),
        tasks=n_tasks, deadline_s=SVC_TCP_DEADLINE_S, wall_s=round(wall, 3),
        scan_launches_serving_thread=serving.get("scan_bitmaps", 0),
        wave_launches_serving_thread=serving.get("match_wave_walk", 0),
        beats=fs["heartbeat"]["beats"], suspects=fs["heartbeat"]["suspects"],
        lease_reclaims=fs["service"]["lease_reclaims"],
        comm_sent=fs["comm"]["sent"], retransmits=fs["comm"]["retransmits"],
        **kept)
    summary["service_tcp"] = dict(wall_s=wall, launches=launches, held=kept,
                                  by_thread={f"{t}:{k}": n for (t, k), n in
                                             threads.by_thread.items()},
                                  fault_stats=fs)
    return launches


def service_chaos_path(summary: dict) -> dict:
    """``path:service-chaos``: tests/test_service.py's chaos plan (drops,
    dups, delays, an agent crash, partitions, lost beats) over its
    workload, 10 machines, on the card: every job done, every task placed
    exactly once, leases reclaimed and messages retransmitted; the same
    plan's all-numpy twin (virtual time makes the run deterministic) makes
    the same placements and fault_stats; a sample of the launches held
    against the plain versions."""
    from repro_torch.kernels.placement_scan import kernel
    from repro_torch.sim import make_workload
    from repro_torch.sim.cluster import scheme
    from repro_torch.svc import ServiceConfig, run_service_workload
    from scripts.service_profile import arrivals as make_arrivals

    arrivals = make_arrivals(make_workload("production", 5, seed=5),
                             20.0, 1, 1)
    n_tasks = sum(a[1].n for a in arrivals)

    def run():
        return run_service_workload(
            arrivals, ServiceConfig(n_machines=SVC_CHAOS_MACHINES, seed=0,
                                    device="cuda"),
            scheme("dagps"), fault_plan=SVC_CHAOS_PLAN)

    kernel.reset_launches()
    with HeldLaunches(kernel) as held:
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
    launches = kernel.launch_counts()
    twin, twin_wall = pinned_numpy(run)
    same_decisions("service-chaos", res, twin, "all-numpy twin")
    check(res.effective == twin.effective
          and res.fault_stats == twin.fault_stats,
          "service-chaos: effective placements or fault_stats differ from "
          "the all-numpy twin's")
    kept = held.hold("service-chaos")
    fs = res.fault_stats
    check(len(res.jobs) == len(arrivals),
          f"service-chaos: {len(res.jobs)} of {len(arrivals)} jobs done")
    check(len(res.effective) == n_tasks
          and all(v == 1 for v in res.effective.values()),
          "service-chaos: a task was not placed exactly once")
    check(fs["service"]["completions"] == n_tasks,
          "service-chaos: completions differ from the task count")
    check(fs["service"]["lease_reclaims"] > 0,
          "service-chaos: no lease was reclaimed")
    check(fs["comm"]["retransmits"] > 0,
          "service-chaos: nothing was retransmitted")
    for name in ("scan_bitmaps", "match_wave_walk"):
        check(launches[name] > 0, f"service-chaos: {name} never launched")
    say("path:service-chaos", machines=SVC_CHAOS_MACHINES,
        jobs=len(res.jobs), tasks=n_tasks, wall_s=round(wall, 3),
        exactly_once=True, lease_reclaims=fs["service"]["lease_reclaims"],
        stale_done=fs["service"]["stale_done"],
        losses=fs["heartbeat"]["losses"], rejoins=fs["heartbeat"]["rejoins"],
        retransmits=fs["comm"]["retransmits"], dropped=fs["comm"]["dropped"],
        duped=fs["comm"]["duped"], delayed=fs["comm"]["delayed"],
        scan_launches=launches["scan_bitmaps"],
        wave_launches=launches["match_wave_walk"],
        makespan=repr(res.makespan), identical_to_numpy=True,
        numpy_wall_s=round(twin_wall, 3), **kept)
    summary["service_chaos"] = dict(wall_s=wall, launches=launches,
                                    numpy_wall_s=twin_wall, held=kept,
                                    fault_stats=fs,
                                    makespan=repr(res.makespan))
    return launches


# ----------------------------------------------------------------------
# phase 5: the LM kernels against their plain versions
# ----------------------------------------------------------------------

#: flash cases: (label, (B, Sq, Sk, H, KV, hd), dtype, opts); the first is
#: the shape of the 8 local layers' prefill at B=4, S=4096; the rest are the
#: other families' prefill shapes, each as its phase launches it: at B=4,
#: S=4096 (phases 11-12) mixtral-8x7b's GQA 32/8 at hd 128 with its window
#: of 4096, deepseek-moe-16b's MHA 16/16 at hd 128 and gemma2-2b's local
#: and global layers (8/4, hd 256, cap 50); at B=1, S=2,048 (phase 13;
#: qwen2-vl: 2,304 with its 256 patches) each of the six others
FLASH_CASES = (
    ("path", (GEN_B, GEN_S, GEN_S, 10, 1, 256), "bfloat16",
     dict(causal=True, window=2048)),
    ("ragged", (2, 1000, 1000, 10, 1, 256), "bfloat16",
     dict(causal=True, window=300)),
    ("cap_noncausal", (2, 777, 1000, 4, 2, 64), "float32",
     dict(causal=False, cap=30.0)),
    ("cap_bf16", (2, 500, 777, 10, 1, 64), "bfloat16",
     dict(causal=False, cap=30.0)),
    ("mixtral", (GEN_B, GEN_S, GEN_S, 32, 8, 128), "bfloat16",
     dict(causal=True, window=4096)),
    ("deepseek", (GEN_B, GEN_S, GEN_S, 16, 16, 128), "bfloat16",
     dict(causal=True)),
    ("gemma2_local", (GEN_B, GEN_S, GEN_S, 8, 4, 256), "bfloat16",
     dict(causal=True, window=4096, cap=50.0)),
    ("gemma2_global", (GEN_B, GEN_S, GEN_S, 8, 4, 256), "bfloat16",
     dict(causal=True, cap=50.0)),
    ("phi4_mini", (FAMILY_B, FAMILY_S, FAMILY_S, 24, 8, 128), "bfloat16",
     dict(causal=True)),
    ("granite", (FAMILY_B, FAMILY_S, FAMILY_S, 32, 8, 128), "bfloat16",
     dict(causal=True)),
    ("codeqwen", (FAMILY_B, FAMILY_S, FAMILY_S, 32, 32, 128), "bfloat16",
     dict(causal=True)),
    ("qwen2_vl", (FAMILY_B, FAMILY_S + 256, FAMILY_S + 256, 28, 4, 128),
     "bfloat16", dict(causal=True)),
    ("musicgen", (FAMILY_B, FAMILY_S, FAMILY_S, 32, 32, 64), "bfloat16",
     dict(causal=True)),
    ("mixtral_b1", (FAMILY_B, FAMILY_S, FAMILY_S, 32, 8, 128), "bfloat16",
     dict(causal=True, window=4096)),
)
#: the cases timed against their plain version, their bound and SDPA: every
#: shape a model's prefill launches
FLASH_TIMED = tuple(c[0] for c in FLASH_CASES
                    if c[0] not in ("ragged", "cap_noncausal", "cap_bf16"))


def flash_case(label, shape, dtype, opts, seed):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ref

    B, Sq, Sk, H, KV, hd = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dt)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    got = kernel.flash_attention(q, k, v, **opts)
    want = ref.attention(q, k, v, **opts)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite output")
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    del diff
    check(ok, f"flash {label}: kernel differs from plain by {err} "
              f"(tolerance {tol} abs + {tol} rel)")
    row = dict(case=label, shape=shape, dtype=dtype, opts=opts,
               max_abs_err=err, tol=tol)
    if label in FLASH_TIMED:
        mask = ref.live_mask(Sq, Sk, causal=opts.get("causal", True),
                             window=opts.get("window"), device="cuda")
        live = int(mask.sum())
        ms = cuda_time_ms(lambda: kernel.flash_attention(q, k, v, **opts), 10)
        plain = cuda_time_ms(lambda: ref.attention(q, k, v, **opts), 3, 1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        # a causal mask alone (no window, or one no query reaches past)
        # goes to SDPA as is_causal, its fastest form
        plain_causal = opts.get("causal", True) and (
            opts.get("window") is None or opts["window"] >= Sq)

        def sdpa():
            if plain_causal:
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        # SDPA has no soft-cap: a capped case has no library call
        lib = lib_err = None
        if opts.get("cap") is None:
            lib_err = float((sdpa().transpose(1, 2).float()
                             - want.float()).abs().max())
            lib = cuda_time_ms(sdpa, 10)
        # each live (q, k) pair: a dot product and a weighted sum over hd
        n_ops = float(live) * 4 * hd * B * H
        b, by = bound_ms(nbytes(q, k, v, got), n_ops, BF16_OPS_PER_S)
        row.update(live_pairs=live, ms=ms, plain_ms=plain, library_ms=lib,
                   library_err=lib_err, bound_ms=b, bound_by=by,
                   tflops=n_ops / ms * 1e-9, bound_share=b / ms,
                   library_ratio=None if lib is None else lib / ms)
    del q, k, v, got, want
    torch.cuda.empty_cache()
    say("kernel", name="flash_attention", case=label,
        shape="B={},Sq={},Sk={},H={},KV={},hd={}".format(*shape),
        dtype=dtype, opts=json.dumps(opts, separators=(",", ":")),
        max_abs_err=f"{err:.3e}", tol=tol,
        **{k: (round(row[k], 6) if isinstance(row[k], float) else row[k])
           for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                     "live_pairs", "tflops", "bound_share", "library_ratio")
           if k in row})
    return row


def kernel_flash(report: list) -> None:
    cases = [flash_case(*c, seed=21 + i) for i, c in enumerate(FLASH_CASES)]
    path = cases[0]
    # the timed case where SDPA leads the kernel most
    worst = min((c for c in cases if c.get("library_ms") is not None),
                key=lambda c: c["library_ratio"])
    report.append(dict(
        library_worst={k: worst[k] for k in (
            "case", "ms", "library_ms", "bound_ms", "library_ratio")},
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:84",
        cases=cases, **{k: path[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")}))


def rglru_case(label, B, S, D, seed):
    """The RG-LRU kernel bitwise against the plain loop, timed back to
    back (``ms``) and in a CUDA graph (``device_ms``), with its bound."""
    import torch

    from repro_torch.kernels.rg_lru import kernel, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, S, D), generator=gen, device="cuda")
    a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.5 + 0.499
    h0 = torch.randn((B, D), generator=gen, device="cuda")
    y, hT = kernel.rglru_scan(x, a, h0)
    y2, hT2 = ref.rglru_scan(x, a, h0)
    torch.cuda.synchronize()
    check(torch.equal(y, y2) and torch.equal(hT, hT2),
          f"rglru_scan {label}: kernel != plain version (bitwise)")
    reps = 20 if S > 1 else 200
    ms = cuda_time_ms(lambda: kernel.rglru_scan(x, a, h0), reps)
    dev_ms = graph_time_ms(lambda: kernel.rglru_scan(x, a, h0), reps)
    plain = cuda_time_ms(lambda: ref.rglru_scan(x, a, h0), 2, 1)
    # one multiply and one add per element
    b, by = bound_ms(nbytes(x, a, h0, y, hT), 2.0 * B * S * D, F32_OPS_PER_S)
    say("kernel", name="rglru_scan", case=label, shape=f"B={B},S={S},D={D}",
        bitwise=True, ms=round(ms, 6), device_ms=round(dev_ms, 6),
        bound_share=round(b / dev_ms, 4), plain_ms=round(plain, 6),
        bound_ms=f"{b:.3e}", bound_by=by)
    return dict(case=label, shape=(B, S, D), max_abs_err=0.0, ms=ms,
                device_ms=dev_ms, plain_ms=plain, bound_ms=b, bound_by=by)


def kernel_rglru(report: list) -> None:
    cases = [rglru_case("prefill", GEN_B, GEN_S, 2560, 31),
             rglru_case("decode", GEN_B, 1, 2560, 32),
             rglru_case("decode_b8", SERVE_B, 1, 2560, 33)]
    report.append(dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/rg_lru/csrc/rg_lru.cu",
        replaces="src/repro/kernels/rg_lru/kernel.py:47",
        library_ms=None, cases=cases, **{k: cases[0][k] for k in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by")}))


#: wkv6 cases: (label, (B, S, H, N), dtype); the first is the prefill of
#: every rwkv6-7b layer at B=4, S=4096, the next two its decode steps.
#: bf16 cases draw unit-scale r, k, v and the model's decays; the f32 case
#: draws as tests/test_kernels.py does (r, k, v at scale 0.5, w in
#: (0.45, 0.95)), the inputs its 2e-5 limit was set for (see `wkv_draw`)
WKV_CASES = (
    ("prefill", (GEN_B, GEN_S, 64, 64), "bfloat16"),
    ("decode_b4", (GEN_B, 1, 64, 64), "bfloat16"),
    ("decode_b8", (SERVE_B, 1, 64, 64), "bfloat16"),
    ("ragged", (2, 1000, 64, 64), "bfloat16"),
    ("smoke_f32", (2, 256, 4, 16), "float32"),
)
#: the kernel's final state against the plain version's (tests/test_kernels)
WKV_STATE_TOL = 1e-3


def close(got, want, tol: float) -> tuple[bool, float]:
    """(every element within tol abs + tol rel, max abs difference)."""
    diff = (got.float() - want.float()).abs()
    return (bool((diff <= tol + tol * want.float().abs()).all()),
            float(diff.max()))


def wkv_draw(shape, dtype, seed, model: bool):
    """r, k, v in ``dtype``; w, u, s0 float32.  ``model``: unit-scale r, k,
    v and decays as the model draws them (w0 ~ U(-6, -5) per channel, moved
    by a data-dependent term of the LoRA's reach), so the state sums
    hundreds of steps and y's terms reach 10 to 100; float32 rounding of
    that sum then exceeds 2e-5 near y = 0 in any two summation orders, and
    float32 is held to `ref.f32_error_bound` instead.  Else the draw of
    tests/test_kernels.py."""
    import torch

    B, S, H, N = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*sz):
        return torch.rand(sz, generator=gen, device="cuda")

    def randn(*sz):
        return torch.randn(sz, generator=gen, device="cuda")
    scale = 1.0 if model else 0.5
    r, k, v = ((randn(*shape) * scale).to(getattr(torch, dtype))
               for _ in range(3))
    if model:
        w = torch.exp(-torch.exp((rand(H, N) - 6.0)
                                 + (rand(*shape) - 0.5) * 0.2))
        u = rand(H, N) * 0.5
    else:
        w = 0.45 + 0.5 * torch.sigmoid(randn(*shape))
        u = randn(H, N) * 0.3
    return r, k, v, w, u, randn(B, H, N, N) * 0.1


def wkv_case(label, shape, dtype, seed):
    import torch

    from repro_torch.kernels.rwkv6 import kernel, ref

    B, S, H, N = shape
    r, k, v, w, u, s0 = wkv_draw(shape, dtype, seed, dtype == "bfloat16")
    y, sT = kernel.wkv6(r, k, v, w, u, s0)
    y2, sT2 = ref.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    check(bool(torch.isfinite(y.float()).all()), f"wkv6 {label}: non-finite")
    ok, err = close(y, y2, tol)
    check(ok, f"wkv6 {label}: y differs from plain by {err} (tolerance {tol} "
              f"abs + {tol} rel)")
    ok, s_err = close(sT, sT2, WKV_STATE_TOL)
    check(ok, f"wkv6 {label}: final state differs from plain by {s_err}")
    row = dict(case=label, shape=shape, dtype=dtype, max_abs_err=err,
               state_err=s_err, tol=tol)
    if dtype == "float32":
        # the same shape at the model's draw, where the fixed 2e-5 does not
        # apply: within twice the first-order float32 rounding bound
        m_args = wkv_draw(shape, dtype, seed, True)
        ym, sm = kernel.wkv6(*m_args)
        ym2, sm2 = ref.wkv6(*m_args)
        yb, sb = ref.f32_error_bound(*m_args)
        dy = (ym.double() - ym2.double()).abs()
        ds = (sm.double() - sm2.double()).abs()
        frac = max(float((dy / (2 * yb)).max()), float((ds / (2 * sb)).max()))
        check(frac <= 1.0, f"wkv6 {label} at the model's draw: kernel and "
                           f"plain part by {frac}x twice the float32 bound")
        row.update(model_draw_err=float(dy.max()),
                   model_draw_bound_frac=frac,
                   model_draw_ymax=float(ym2.abs().max()))
    if S > 1:
        # chained halves: the state the first half returns carries the
        # second; each step's arithmetic is the same, so bitwise
        h = S // 2
        ya, sA = kernel.wkv6(*[t[:, :h].contiguous() for t in (r, k, v, w)],
                             u, s0)
        yb, sB = kernel.wkv6(*[t[:, h:].contiguous() for t in (r, k, v, w)],
                             u, sA)
        torch.cuda.synchronize()
        check(torch.equal(torch.cat([ya, yb], 1), y) and torch.equal(sB, sT),
              f"wkv6 {label}: chained halves != the whole run")
        row.update(halves_bitwise=True)
    reps = (10, 1) if S > 1000 else (200, 20)
    ms = cuda_time_ms(lambda: kernel.wkv6(r, k, v, w, u, s0), reps[0])
    dev_ms = graph_time_ms(lambda: kernel.wkv6(r, k, v, w, u, s0),
                           5 if S > 1000 else (20 if S > 1 else 200))
    plain = cuda_time_ms(lambda: ref.wkv6(r, k, v, w, u, s0), reps[1], 0)
    # per state element and step, y += r_i*S_ij (an FMA) and S_ij = w_i*S_ij
    # + k_i*v_j (a product and an FMA): 5; the bonus sum_i r_i*u_i*k_i*v_j
    # is v_j times one dot product per (b, t, h), 3 N + 2 N more
    n_ops = 5.0 * B * S * H * (N * N + N)
    b, by = bound_ms(nbytes(r, k, v, w, u, s0, y, sT), n_ops, F32_OPS_PER_S)
    row.update(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b,
               bound_by=by, bound_share=b / dev_ms)
    say("kernel", name="wkv6", case=label, shape="B={},S={},H={},N={}".format(
        *shape), dtype=dtype, max_abs_err=f"{err:.3e}",
        state_err=f"{s_err:.3e}", tol=tol,
        **{k: row[k] for k in ("halves_bitwise", "model_draw_err",
                               "model_draw_bound_frac", "model_draw_ymax")
           if k in row},
        ms=round(ms, 6), device_ms=round(dev_ms, 6),
        plain_ms=round(plain, 6), bound_ms=f"{b:.3e}", bound_by=by,
        bound_share=round(b / dev_ms, 4))
    return row


def kernel_wkv6(report: list) -> None:
    cases = [wkv_case(*c, seed=41 + i) for i, c in enumerate(WKV_CASES)]
    report.append(dict(
        name="wkv6", route="cuda",
        source="src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6/kernel.py:59",
        library_ms=None, cases=cases, **{k: cases[0][k] for k in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by")}))


# ----------------------------------------------------------------------
# phases 6, 7, 9 and 10: full-width serving
# ----------------------------------------------------------------------

def lm_families():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rg_lru import kernel as rk
    from repro_torch.kernels.rwkv6 import kernel as wk
    return fk, rk, wk


def lm_launches() -> dict:
    return {k: v for fam in lm_families()
            for k, v in fam.launch_counts().items()}


def lm_reset() -> None:
    for fam in lm_families():
        fam.reset_launches()


def set_pin(plain: bool) -> None:
    from repro_torch.kernels import pin
    if plain:
        os.environ[pin.PIN_ENV] = "plain"
    else:
        os.environ.pop(pin.PIN_ENV, None)


def full_model(arch: str, n_layers: int | None = None):
    """``arch``'s full() config (cut to ``n_layers`` layers when given:
    depth only, never width) and random bf16 weights from seed `SEED`."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import model as M

    cfg = configs.get(arch)
    full_layers = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    init_s = time.perf_counter() - t0
    say("lm:model", arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab, params=n, dtype="bfloat16", init_s=round(init_s, 3),
        **({"reduced": f"n_layers {full_layers}->{cfg.n_layers}"}
           if cfg.n_layers != full_layers else {}))
    return cfg, params, n


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


class RouteLog:
    """Within the block, every ``layers.moe_route`` call's expert choices
    (idx (g, T, K)) in call order: one per MoE layer of a prefill."""

    def __enter__(self):
        from repro_torch.models import layers as L

        self.layers, self.inner, self.calls = L, L.moe_route, []

        def route(*args, **kw):
            w, idx = self.inner(*args, **kw)
            self.calls.append(idx)
            return w, idx
        L.moe_route = route
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.inner


def routing_diff(cfg, a: list, b: list) -> dict:
    """How many of the (token, expert) choices of run ``a`` run ``b`` did
    not make, over every MoE layer of one prefill; a near-tie of the
    router may flip one, a wrong router flips most."""
    import torch

    if cfg.moe is None:
        return {}
    check(len(a) == len(b) == sum(f == "moe" for _, f in cfg.layer_plan),
          f"routing recorded {len(a)} / {len(b)} MoE layers")
    E, n = cfg.moe.n_experts, 0
    for x, y in zip(a, b):
        hot = [torch.zeros(*t.shape[:-1], E, dtype=torch.bool,
                           device=t.device).scatter_(-1, t, True)
               for t in (x, y)]
        n += int((hot[0] & ~hot[1]).sum())
    return dict(routing_differ=n, routing_choices=sum(x.numel() for x in a))


def generate_run(cfg, params, prompt, plain: bool) -> dict:
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve import greedy_generate

    from repro_torch.serve import engine

    # time greedy_generate's prefill and each of its decode steps
    # (synchronized on both sides); keep the prefill's logits
    make_step, step_s = engine.make_decode_fn, []
    prefill, pre = M.prefill, {}

    def timed_prefill(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with RouteLog() as log:
            out = prefill(*args, **kw)
        torch.cuda.synchronize()
        pre["s"], pre["logits"] = time.perf_counter() - t, out[0]
        pre["routes"] = log.calls
        return out

    def timed_make(c):
        step = make_step(c)

        def timed(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            return out
        return timed

    set_pin(plain)
    engine.make_decode_fn = timed_make
    M.prefill = timed_prefill
    try:
        lm_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = greedy_generate(params, cfg, prompt, GEN_NEW, device="cuda")
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = lm_launches()
    finally:
        engine.make_decode_fn = make_step
        M.prefill = prefill
        set_pin(False)
    check(len(step_s) == GEN_NEW, f"{len(step_s)} decode steps timed")
    logits, prefill_s = pre["logits"], pre["s"]
    check(tuple(logits.shape) == (GEN_B, 1, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits: shape {tuple(logits.shape)} or non-finite")
    check(tuple(toks.shape) == (GEN_B, GEN_NEW)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "generated tokens out of shape or range")
    return dict(logits=logits.float(), tokens=toks.cpu(), prefill_s=prefill_s,
                generate_s=gen_s, step_ms=[t * 1e3 for t in step_s],
                launches=launches, routes=pre["routes"])


def decode_turns(cfg, params, prompt, rounds: int = 6) -> dict:
    """Decode steps through the kernels and through the plain versions in
    turns (kernels, plain, plain, kernels, ...) on one decode state, so both
    sides see the same host and card.  Returns each side's synchronized
    step times and the host time spent inside the rg_lru op per step."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve import pad_prefill_state

    _, state = M.prefill(params, cfg, {"tokens": prompt}, last_only=True)
    state = pad_prefill_state(cfg, state, GEN_S + 4 * rounds)
    scan, in_scan = L.rglru_scan, [0.0]

    def timed_scan(*args):
        t = time.perf_counter()
        out = scan(*args)
        in_scan[0] += time.perf_counter() - t
        return out

    tok = prompt[:, -1:]
    pos = torch.full((GEN_B,), GEN_S, dtype=torch.long, device="cuda")
    out = {"kernels": ([], []), "plain": ([], [])}
    L.rglru_scan = timed_scan
    try:
        for plain in (False, True, True, False) * rounds:
            set_pin(plain)
            in_scan[0] = 0.0
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, state = M.decode_step(params, cfg, state, tok, pos)
            torch.cuda.synchronize()
            step, host = out["plain" if plain else "kernels"]
            step.append((time.perf_counter() - t) * 1e3)
            host.append(in_scan[0] * 1e3)
            tok = logits[:, -1:].argmax(-1)
            pos = pos + 1
    finally:
        L.rglru_scan = scan
        set_pin(False)
    return {side: dict(step_ms=steps, scan_host_ms=host,
                       step_ms_median=sorted(steps)[len(steps) // 2],
                       scan_host_ms_median=sorted(host)[len(host) // 2])
            for side, (steps, host) in out.items()}


def path_launches(cfg) -> tuple[dict, dict]:
    """Kernel launches of one prefill and of one decode step: flash in each
    attention layer's prefill (decode attention is plain PyTorch), rg_lru
    and wkv6 in each recurrent layer's prefill and step."""
    n = {kind: sum(m == kind for m, _ in cfg.layer_plan)
         for kind in ("attn", "local", "rglru", "rwkv")}
    step = {"flash_attention": 0, "flash_attention_bwd": 0,
            "rglru_scan": n["rglru"], "rglru_scan_bwd": 0, "wkv6": n["rwkv"],
            "wkv6_bwd": 0}
    return dict(step, flash_attention=n["attn"] + n["local"]), step


def f32_logits(cfg, params, tokens, patches=None):
    """Last-position prefill logits of the same weights in float32 on the
    prompt ``tokens`` (behind ``patches`` for a vision model),
    through the plain versions: the yardstick of bf16 rounding on either
    path.  The layers are cast one at a time (deepseek-moe-16b's 66 GB of
    float32 weights would not fit beside its 33 GB of bf16 ones)."""
    import torch

    from repro_torch.models import model as M

    def f32(node):
        if isinstance(node, dict):
            return {k: f32(v) for k, v in node.items()}
        return node.float()
    set_pin(True)
    try:
        with torch.no_grad():
            top = f32({k: v for k, v in params.items() if k != "layers"})
            batch = {"tokens": tokens}
            if patches is not None:
                batch["patches"] = patches
            x, positions = M._embed(top, cfg, batch)
            for bp, (mixer, ffn) in zip(params["layers"], cfg.layer_plan):
                x, _ = M._apply_block(f32(bp), x, cfg, mixer, ffn, positions,
                                      "train", None)
            logits = M._lm_logits(top, cfg, x[:, -1:])
    finally:
        set_pin(False)
    del top, x
    torch.cuda.empty_cache()
    return logits


def logit_checks(arch, cfg, kern, twin, ref32) -> tuple[dict, list]:
    """Kernel path against its plain twin (max and mean |diff| of the
    last-position logits within `LOGIT_TOL`) and both against the float32
    yardstick (`F32_DISTANCE_RATIO`), over the vocabulary's own slots (the
    padded ones hold -1e9, which bf16 rounds by megaunits).  Returns the
    readings and the checks still to make (each a (condition, message)
    pair), so the caller can print its line first."""
    import torch

    kern, twin, ref32 = (x[..., :cfg.vocab] for x in (kern, twin, ref32))
    tol_max, tol_mean = LOGIT_TOL[arch]
    diff = (kern - twin).abs()
    d_max, d_mean = float(diff.max()), float(diff.mean())
    to_f32 = {tag: [float(f((x - ref32).abs())) for f in
                    (torch.max, torch.mean)]
              for tag, x in (("kernels", kern), ("plain_twin", twin))}
    readings = dict(logits_max_abs_diff=d_max, logits_mean_abs_diff=d_mean,
                    tol=[tol_max, tol_mean], f32_max_mean_diff=to_f32,
                    logits_std=float(twin.std()))
    checks = [
        (d_max <= tol_max and d_mean <= tol_mean,
         f"{arch}: prefill logits differ from the plain twin: max {d_max} "
         f"(tol {tol_max}), mean {d_mean} (tol {tol_mean})"),
        (all(k <= F32_DISTANCE_RATIO * t for k, t in
             zip(to_f32["kernels"], to_f32["plain_twin"])),
         f"{arch}: the kernel path is further from the float32 model than "
         f"its plain twin by more than {F32_DISTANCE_RATIO}x: {to_f32}")]
    return readings, checks


def fmt(readings: dict) -> dict:
    """`logit_checks` readings as the fields of a printed line."""
    return dict(
        logits_max_abs_diff=f"{readings['logits_max_abs_diff']:.4e}",
        logits_mean_abs_diff=f"{readings['logits_mean_abs_diff']:.4e}",
        tol="{}/{}".format(*readings["tol"]),
        logits_std=f"{readings['logits_std']:.4e}",
        f32_max_mean_diff=json.dumps(
            {k: [f"{x:.4e}" for x in v]
             for k, v in readings["f32_max_mean_diff"].items()},
            separators=(",", ":")))


def lm_generate(arch, cfg, params, summary: dict, turns: bool) -> dict:
    import torch

    pre, step = path_launches(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab, (GEN_B, GEN_S), generator=gen,
                           device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kern = generate_run(cfg, params, prompt, plain=False)
    peak = torch.cuda.max_memory_allocated()
    twin = generate_run(cfg, params, prompt, plain=True)
    if turns:
        turns = decode_turns(cfg, params, prompt)
        say("lm:decode_turns", order="kernels,plain,plain,kernels x6",
            step_ms_median=round(turns["kernels"]["step_ms_median"], 3),
            twin_step_ms_median=round(turns["plain"]["step_ms_median"], 3),
            rglru_host_ms_per_step=round(
                turns["kernels"]["scan_host_ms_median"], 3),
            twin_rglru_host_ms_per_step=round(
                turns["plain"]["scan_host_ms_median"], 3))
    want = {k: pre[k] + GEN_NEW * step[k] for k in pre}
    check(kern["launches"] == want,
          f"generate launches {kern['launches']}, expected {want}")
    check(not any(twin["launches"].values()),
          f"the plain-pinned twin launched kernels: {twin['launches']}")
    readings, checks = logit_checks(arch, cfg, kern["logits"],
                                    twin["logits"],
                                    f32_logits(cfg, params, prompt))
    routes = routing_diff(cfg, kern.pop("routes"), twin.pop("routes"))
    same = kern["tokens"] == twin["tokens"]
    per_step = [int(c) for c in same.sum(0)]
    first_miss = [int(r.logical_not().nonzero()[0]) if not bool(r.all())
                  else None for r in same]
    argmax_same = bool(torch.equal(kern["logits"].argmax(-1),
                                   twin["logits"].argmax(-1)))
    out = {}
    for tag, r in (("kernels", kern), ("plain_twin", twin)):
        ms = sorted(r["step_ms"])
        out[tag] = dict(prefill_s=r["prefill_s"], generate_s=r["generate_s"],
                        decode_step_ms=ms[len(ms) // 2],
                        decode_step_ms_mean=sum(ms) / len(ms),
                        decode_step_ms_all=r["step_ms"],
                        launches=r["launches"])
    say("lm:generate", arch=arch, B=GEN_B, S0=GEN_S, n_new=GEN_NEW,
        pin="REPRO_LM_KERNELS=plain (twin)", **fmt(readings),
        first_token_same=argmax_same,
        tokens_same_per_step=",".join(map(str, per_step)),
        first_divergence=first_miss, **routes,
        prefill_s=round(kern["prefill_s"], 4),
        twin_prefill_s=round(twin["prefill_s"], 4),
        generate_s=round(kern["generate_s"], 4),
        twin_generate_s=round(twin["generate_s"], 4),
        decode_step_ms_median=round(out["kernels"]["decode_step_ms"], 3),
        twin_decode_step_ms_median=round(
            out["plain_twin"]["decode_step_ms"], 3),
        launches=json.dumps(kern["launches"], separators=(",", ":")),
        twin_launches=json.dumps(twin["launches"], separators=(",", ":")),
        peak_gb=round(peak / 1e9, 3))
    summary[f"{arch}:generate"] = dict(
        out, **readings, **routes,
        tokens_same_per_step=per_step, first_divergence=first_miss,
        first_token_same=argmax_same, peak_bytes=peak, decode_turns=turns)
    for cond, what in checks:
        check(cond, what)
    return kern["launches"]


def lm_serve(arch, cfg, params, summary: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.serve import Batcher, ServeConfig

    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab, SERVE_PROMPT)
               for _ in range(SERVE_N)]
    batcher = Batcher(params, cfg, ServeConfig(batch=SERVE_B,
                                               max_seq=SERVE_MAX_SEQ),
                      device="cuda")
    inner, steps = batcher.step, [0]

    def counted(*args):
        steps[0] += 1
        return inner(*args)

    batcher.step = counted
    lm_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = batcher.serve(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lm_launches()
    answered = sum(r is not None and len(r) == SERVE_NEW
                   and bool(((r >= 0) & (r < cfg.vocab)).all()) for r in res)
    check(answered == SERVE_N, f"Batcher answered {answered} of {SERVE_N}")
    want = {k: n * steps[0] for k, n in path_launches(cfg)[1].items()}
    check(launches == want, f"Batcher launches {launches}, expected {want}")
    say("lm:serve", arch=arch, batch=SERVE_B, max_seq=SERVE_MAX_SEQ, requests=SERVE_N,
        answered=answered, prompt=SERVE_PROMPT, n_new=SERVE_NEW,
        decode_steps=steps[0], wall_s=round(wall, 4),
        step_ms=round(wall / steps[0] * 1e3, 3),
        launches=json.dumps(launches, separators=(",", ":")))
    summary[f"{arch}:serve"] = dict(answered=answered, decode_steps=steps[0],
                            wall_s=wall, step_ms=wall / steps[0] * 1e3,
                            launches=launches)
    return launches


def family_batch(cfg) -> dict:
    """The phase's prompt: B=1 x 2,048 tokens (codes for all K codebooks
    of an audio model) and, for a vision model, its patch embeddings,
    drawn on the card from seed ``SEED + 3``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    shape = (FAMILY_B, FAMILY_S) + ((cfg.n_codebooks,)
                                    if cfg.n_codebooks > 1 else ())
    batch = {"tokens": torch.randint(0, cfg.vocab, shape, generator=gen,
                                     device="cuda")}
    if cfg.vlm_patches:
        batch["patches"] = torch.randn(
            (FAMILY_B, cfg.vlm_patches, cfg.d_model), generator=gen,
            device="cuda")
    return batch


def family_run(cfg, params, batch, plain: bool) -> dict:
    """`prefill` of the batch (last position only), then `FAMILY_STEPS`
    greedy `decode_step`s, each synchronized and timed; the launches of
    each part and the prefill's routing choices."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve import pad_prefill_state

    set_pin(plain)
    try:
        lm_reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with RouteLog() as log:
            logits, state = M.prefill(params, cfg, batch, last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        pre_launches = lm_launches()
        lm_reset()
        S0 = cfg.vlm_patches + FAMILY_S
        state = pad_prefill_state(cfg, state, S0 + FAMILY_STEPS)
        tok = logits[:, -1:].argmax(-1)                # (B, 1) or (B, 1, K)
        pos = torch.full((FAMILY_B,), S0, dtype=torch.long, device="cuda")
        toks, step_ms = [], []
        for _ in range(FAMILY_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, state = M.decode_step(params, cfg, state, tok, pos)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            check(bool(torch.isfinite(out).all()), "non-finite decode logits")
            tok = out[:, -1:].argmax(-1)
            toks.append(tok)
            pos = pos + 1
        step_launches = lm_launches()
    finally:
        set_pin(False)
    want = (FAMILY_B, 1) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1
                            else ()) + (cfg.vocab_padded,)
    check(tuple(logits.shape) == want and bool(torch.isfinite(logits).all()),
          f"prefill logits: shape {tuple(logits.shape)} (want {want}) or "
          "non-finite")
    toks = torch.cat(toks, dim=1).cpu()
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "decoded tokens out of range")
    del state
    return dict(logits=logits.float(), routes=log.calls, tokens=toks,
                prefill_s=prefill_s, step_ms=step_ms,
                launches=pre_launches, step_launches=step_launches)


def lm_family(arch, summary: dict, lm_params: dict) -> dict:
    """Phase 13 for one family: full width (depth cut only where
    `FAMILY_LAYERS` says), `family_run` through the kernels and through
    its plain-pinned twin, the float32 yardstick, limits and launches."""
    import torch

    from repro_torch import configs

    cfg, params, lm_params[arch] = full_model(arch, FAMILY_LAYERS.get(arch))
    batch = family_batch(cfg)
    torch.cuda.reset_peak_memory_stats()
    kern = family_run(cfg, params, batch, plain=False)
    peak = torch.cuda.max_memory_allocated()
    twin = family_run(cfg, params, batch, plain=True)
    pre, step = path_launches(cfg)
    check(kern["launches"] == pre,
          f"{arch} prefill launches {kern['launches']}, expected {pre}")
    want = {k: FAMILY_STEPS * n for k, n in step.items()}
    check(kern["step_launches"] == want,
          f"{arch} decode launches {kern['step_launches']}, expected {want}")
    check(not any(twin["launches"].values())
          and not any(twin["step_launches"].values()),
          f"the plain-pinned twin launched kernels: {twin['launches']}")
    readings, checks = logit_checks(arch, cfg, kern["logits"],
                                    twin["logits"],
                                    f32_logits(cfg, params, batch["tokens"],
                                               batch.get("patches")))
    routes = routing_diff(cfg, kern.pop("routes"), twin.pop("routes"))
    del params
    torch.cuda.empty_cache()
    same = (kern["tokens"] == twin["tokens"]).reshape(FAMILY_B,
                                                      FAMILY_STEPS, -1)
    row = dict(
        layers=cfg.n_layers, params=lm_params[arch], peak_gb=peak / 1e9,
        prefill_s=kern["prefill_s"], twin_prefill_s=twin["prefill_s"],
        step_ms=sorted(kern["step_ms"])[FAMILY_STEPS // 2],
        twin_step_ms=sorted(twin["step_ms"])[FAMILY_STEPS // 2],
        step_ms_all=kern["step_ms"],
        flash_launches=kern["launches"]["flash_attention"],
        tokens_same_steps=int(same.all(-1).sum()), **readings, **routes)
    if arch in FAMILY_LAYERS:
        row["reduced"] = f"n_layers {configs.get(arch).n_layers}->{cfg.n_layers}"
    say("lm:family", arch=arch, B=FAMILY_B,
        S0=f"{FAMILY_S}" + (f"+{cfg.vlm_patches} patches"
                            if cfg.vlm_patches else ""),
        steps=FAMILY_STEPS, layers=cfg.n_layers,
        **({"reduced": row["reduced"]} if "reduced" in row else {}),
        params=row["params"], peak_gb=round(row["peak_gb"], 3),
        prefill_s=round(row["prefill_s"], 4),
        twin_prefill_s=round(row["twin_prefill_s"], 4),
        step_ms=round(row["step_ms"], 3),
        twin_step_ms=round(row["twin_step_ms"], 3), **fmt(readings),
        tokens_same_steps=f"{row['tokens_same_steps']}/{FAMILY_STEPS}",
        flash_launches=row["flash_launches"],
        path_launches=pre["flash_attention"], **routes)
    summary[f"{arch}:family"] = row
    for cond, what in checks:
        check(cond, what)
    return {k: kern["launches"][k] + kern["step_launches"][k]
            for k in kern["launches"]}

# ----------------------------------------------------------------------
# phase 14: the backward kernels against their plain versions
# ----------------------------------------------------------------------

#: the training slice's shapes: (B, S) of each microbatch and the global
#: batch (TRAIN_MB microbatches), AdamW's settings and the steps taken
TRAIN_B, TRAIN_MB, TRAIN_S, TRAIN_STEPS = 2, 2, 4096, 4
TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10)
#: rwkv6-7b takes the JAX package's own AdamW schedule (its defaults: lr
#: 3e-4 after 100 warmup steps, so 3e-6 k at step k): at full lr from the
#: first step its loss rises on the repeated batch, 11.61 -> 33.07 ->
#: 24.58 (scripts/train_lr_sweep.py, NVIDIA H100 80GB HBM3, 700 W, seed
#: 88; 3e-5 rises too, 1e-5 and below fall)
TRAIN_OPTS = {"rwkv6_7b": dict(lr=3e-4, warmup_steps=100,
                               total_steps=10_000)}
#: flash backward cases: (label, (B, Sq, Sk, H, KV, hd), dtype, opts); the
#: first is recurrentgemma-2b's local layer at a training microbatch
#: (B=1, S=4,096), then a ragged S, gemma2's GQA 8/4 at hd 256 with cap
#: 50 (and again with q and k scaled by `FLASH_BWD_QK_SCALE`, so the scores
#: reach the cap and its derivative counts: at unit scale they stay near 1
#: against a cap of 50, where 1 - tanh^2 > 0.999), an MHA shape at hd 128
#: and float32 at a narrow width
FLASH_BWD_CASES = (
    ("train", (1, TRAIN_S, TRAIN_S, 10, 1, 256), "bfloat16",
     dict(causal=True, window=2048)),
    ("ragged", (1, 1000, 1000, 10, 1, 256), "bfloat16",
     dict(causal=True, window=300)),
    ("gemma2_gqa", (1, TRAIN_S, TRAIN_S, 8, 4, 256), "bfloat16",
     dict(causal=True, cap=50.0)),
    ("cap_near", (1, 1024, 1024, 8, 4, 256), "bfloat16",
     dict(causal=True, cap=50.0)),
    ("mha_hd128", (1, 2048, 2048, 16, 16, 128), "bfloat16",
     dict(causal=True)),
    ("f32_narrow", (2, 300, 300, 4, 2, 64), "float32",
     dict(causal=True, window=100)),
)
#: dq, dk, dv against the plain version: max |diff| over the plain
#: version's max |value| (the forward's limits, tests/test_kernels.py:
#: bf16 outputs keep 8 significant bits; float32 sums in another order)
FLASH_BWD_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
#: the training forward (the kernel that stores each row's log-sum-exp)
#: against ``ref.attention(return_lse=True)`` on the same q, k, v: o within
#: `FLASH_BWD_TOL`, lse within this many nats (an error e in lse scales
#: every P of its row by exp(-e); the card tests hold it to 1e-4 too)
FLASH_LSE_TOL = 1e-4
FLASH_BWD_QK_SCALE = {"cap_near": 4.0}
RGLRU_BWD_CASES = (("train", 1, TRAIN_S, 2560), ("b4", 4, TRAIN_S, 2560))
#: WKV6 backward cases: (label, (B, S, H, N), dtype, with dsT); the first is
#: rwkv6-7b's layer at a training microbatch (B=1, S=4,096, 64 heads of
#: 64), then B=4, an S off the kernel's 16-step chunk, S=1 and float32 at
#: N=16.  Inputs at the model's scale (`wkv_draw`), dy unit normal in r's
#: dtype; the training call's dsT is zero (the final state is unused)
WKV_BWD_CASES = (
    ("train", (1, TRAIN_S, 64, 64), "bfloat16", False),
    ("b4", (4, TRAIN_S, 64, 64), "bfloat16", False),
    ("ragged", (1, 1001, 64, 64), "bfloat16", True),
    ("s1", (4, 1, 64, 64), "bfloat16", True),
    ("f32_n16", (2, 300, 4, 16), "float32", True),
)


def flash_bwd_case(label, shape, dtype, opts, seed, timed=True) -> dict:
    """The training forward's o and lse against ``ref.attention``'s (o
    within `FLASH_BWD_TOL`, lse within `FLASH_LSE_TOL`), then the backward
    kernel on the kernel forward's o and lse against ``ref.attention_bwd``
    on the plain forward's: dq, dk and dv within `FLASH_BWD_TOL` of the
    plain version's max magnitude, and a second call bitwise equal to the
    first; then (``timed``) the kernel (and the
    cumulative times of its three launches), the forward with its
    log-sum-exp, the plain version and SDPA's backward timed.  Untimed, it
    returns the backward's errors unchecked (the mutant control reads
    them); the forward is checked either way."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ref

    B, Sq, Sk, H, KV, hd = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sc = FLASH_BWD_QK_SCALE.get(label, 1.0)
    q, k, v, do = (torch.randn(s, generator=gen, device="cuda").mul(m).to(dt)
                   for s, m in (((B, Sq, H, hd), sc), ((B, Sk, KV, hd), sc),
                                ((B, Sk, KV, hd), 1.0),
                                ((B, Sq, H, hd), 1.0)))
    tol = FLASH_BWD_TOL[dtype]
    o, lse = kernel.flash_attention(q, k, v, return_lse=True, **opts)
    o_p, lse_p = ref.attention(q, k, v, return_lse=True, **opts)
    o_err = float((o.float() - o_p.float()).abs().max()
                  / o_p.float().abs().max())
    lse_err = float((lse - lse_p).abs().max())
    check(bool(torch.isfinite(lse).all()) and o_err <= tol
          and lse_err <= FLASH_LSE_TOL,
          f"flash_attention (return_lse) {label}: o {o_err:.3e} over the "
          f"plain version's max (limit {tol}), lse {lse_err:.3e} nats "
          f"(limit {FLASH_LSE_TOL})")
    got = kernel.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    want = ref.attention_bwd(q, k, v, o_p, lse_p, do, **opts)
    del o_p, lse_p
    torch.cuda.synchronize()
    errs = {name: float((g.float() - w.float()).abs().max()
                        / w.float().abs().max())
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    if not timed:
        del q, k, v, do, o, lse, got, want
        torch.cuda.empty_cache()
        return dict(case=label, rel_errs=errs, tol=tol,
                    caught=not all(e <= tol for e in errs.values()))
    check(all(bool(torch.isfinite(g.float()).all()) for g in got),
          f"flash_attention_bwd {label}: non-finite gradients")
    check(all(e <= tol for e in errs.values()),
          f"flash_attention_bwd {label}: {errs} over the plain version's "
          f"max (limit {tol})")
    # no atomics: a second call gives the same bits
    again = kernel.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"flash_attention_bwd {label}: two calls differ")
    del again
    mask = ref.live_mask(Sq, Sk, causal=opts.get("causal", True),
                         window=opts.get("window"), device="cuda")
    live = int(mask.sum())
    ms = cuda_time_ms(lambda: kernel.flash_attention_bwd(
        q, k, v, o, lse, do, **opts), 5, 1)
    # the three launches in turn: D alone, D + dK/dV, all three
    part_ms = [cuda_time_ms(lambda: kernel.flash_attention_bwd(
        q, k, v, o, lse, do, parts=p, **opts), 5, 1) for p in (1, 3, 7)]
    split = dict(delta_ms=part_ms[0], dkdv_ms=part_ms[1] - part_ms[0],
                 dq_ms=part_ms[2] - part_ms[1])
    fwd_ms = cuda_time_ms(lambda: kernel.flash_attention(
        q, k, v, return_lse=True, **opts), 5, 1)
    plain = cuda_time_ms(lambda: ref.attention_bwd(q, k, v, o, lse, do,
                                                   **opts), 2, 1)
    # SDPA's backward through autograd (the forward outside the timing);
    # it has no soft-cap, so a capped case has no library call
    lib = None
    if opts.get("cap") is None:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        causal_only = opts.get("causal", True) and (
            opts.get("window") is None or opts["window"] >= Sq)
        out = (F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
               if causal_only else
               F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True))
        dot = do.transpose(1, 2)
        lib = cuda_time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 5, 1)
        del qt, kt, vt, out
    # recomputing S, then dP, dV, dQ, dK: five hd-long products per live
    # (q, k) pair, 2 hd operations each; q, k, v, o, do (and lse) read,
    # dq, dk, dv written once
    n_ops = float(live) * 10 * hd * B * H
    peak = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    b, by = bound_ms(nbytes(q, k, v, o, do, lse, *got), n_ops, peak)
    row = dict(case=label, shape=shape, dtype=dtype, opts=opts,
               max_abs_err=max(errs.values()), rel_errs=errs, tol=tol,
               fwd_o_rel_err=o_err, fwd_lse_err=lse_err, **split,
               live_pairs=live, ms=ms, fwd_ms=fwd_ms, plain_ms=plain,
               library_ms=lib,
               bound_ms=b, bound_by=by, bound_share=b / ms)
    say("kernel", name="flash_attention_bwd", case=label,
        shape="B={},Sq={},Sk={},H={},KV={},hd={}".format(*shape),
        dtype=dtype, opts=json.dumps(opts, separators=(",", ":")),
        rel_err=json.dumps({k: f"{e:.3e}" for k, e in errs.items()},
                            separators=(",", ":")), tol=tol,
        fwd_o_err=f"{o_err:.3e}", fwd_lse_err=f"{lse_err:.3e}",
        repeat_bitwise=True, ms=round(ms, 6),
        **{k: round(t, 6) for k, t in split.items()},
        fwd_lse_ms=round(fwd_ms, 6),
        plain_ms=round(plain, 6),
        library_ms=None if lib is None else round(lib, 6),
        bound_ms=f"{b:.4e}", bound_by=by, bound_share=round(b / ms, 5),
        tflops=round(n_ops / ms * 1e-9, 3))
    del q, k, v, do, o, lse, got, want, mask
    torch.cuda.empty_cache()
    return row


def rglru_bwd_case(label, B, S, D, seed, timed=True) -> dict:
    import torch

    from repro_torch.kernels.rg_lru import kernel, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, S, D), generator=gen, device="cuda")
    a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.5 + 0.499
    h0 = torch.randn((B, D), generator=gen, device="cuda")
    dh = torch.randn((B, S, D), generator=gen, device="cuda")
    dhT = torch.randn((B, D), generator=gen, device="cuda")
    h, _ = kernel.rglru_scan(x, a, h0)
    got = kernel.rglru_scan_bwd(a, h, h0, dh, dhT)
    want = ref.rglru_scan_bwd(a, h, h0, dh, dhT)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    if not timed:
        return dict(case=label, bitwise=bitwise, caught=not bitwise)
    check(bitwise,
          f"rglru_scan_bwd {label}: kernel != plain version (bitwise)")
    ms = cuda_time_ms(lambda: kernel.rglru_scan_bwd(a, h, h0, dh, dhT), 20)
    fwd_ms = cuda_time_ms(lambda: kernel.rglru_scan(x, a, h0), 20)
    dev_ms = graph_time_ms(lambda: kernel.rglru_scan_bwd(a, h, h0, dh, dhT),
                           20)
    plain = cuda_time_ms(lambda: ref.rglru_scan_bwd(a, h, h0, dh, dhT), 1, 1)
    # a, h and dh read, dx and da written; an add and two multiplies each
    b, by = bound_ms(nbytes(a, h, dh, h0, dhT, *got), 3.0 * B * S * D,
                     F32_OPS_PER_S)
    say("kernel", name="rglru_scan_bwd", case=label, shape=f"B={B},S={S},D={D}",
        bitwise=True, ms=round(ms, 6), device_ms=round(dev_ms, 6),
        bound_share=round(b / dev_ms, 4), plain_ms=round(plain, 6),
        bound_ms=f"{b:.3e}", bound_by=by, fwd_ms=round(fwd_ms, 6))
    del x, a, h0, dh, dhT, h, got, want
    torch.cuda.empty_cache()
    return dict(case=label, shape=(B, S, D), max_abs_err=0.0, ms=ms,
                fwd_ms=fwd_ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b,
                bound_by=by)


def wkv6_bwd_case(label, shape, dtype, with_dsT, seed, timed=True) -> dict:
    """The backward kernel's six gradients (dr, dk, dv, dw, du, ds0) against
    ``ref.wkv6_bwd`` on the same inputs.  Both are float32 evaluations of
    one function (bf16 r, k, v and dy are exact in float32), so each
    element lies within twice ``ref.f32_bwd_error_bound`` (first-order
    float32 rounding of any summation order, float64) of the other: that
    is the limit, no chosen number.  A second call gives the same bits (no
    atomics).  Then (``timed``) the kernel, the forward kernel on the same
    inputs and the plain version are timed.  Untimed, the readings are
    returned unchecked (the mutant control reads them)."""
    import torch

    from repro_torch.kernels.rwkv6 import kernel, ref

    B, S, H, N = shape
    r, k, v, w, u, s0 = wkv_draw(shape, dtype, seed, True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    dy = torch.randn(shape, generator=gen, device="cuda").to(r.dtype)
    dsT = (torch.randn((B, H, N, N), generator=gen, device="cuda")
           if with_dsT else None)
    args = (r, k, v, w, u, s0, dy, dsT)
    got = kernel.wkv6_bwd(*args)
    want = ref.wkv6_bwd(*args)
    bound = ref.f32_bwd_error_bound(*args)
    torch.cuda.synchronize()
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    errs, fracs = {}, {}
    for name, g, w_, b in zip(names, got, want, bound):
        d = (g.double() - w_.double()).abs()
        errs[name] = float(d.max())
        # where the bound is 0 (dw at the last step when dsT is 0) the two
        # must agree exactly: a difference there reads as inf
        fracs[name] = float(torch.where(d == 0, torch.zeros_like(d),
                                        d / (2 * b)).max())
    del want, bound
    frac = max(fracs.values())
    if not timed:
        del args, got
        torch.cuda.empty_cache()
        return dict(case=label, abs_errs=errs, bound_fracs=fracs,
                    caught=not frac <= 1.0)
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"wkv6_bwd {label}: non-finite gradients")
    check(frac <= 1.0, f"wkv6_bwd {label}: kernel and plain version part by "
                       f"{fracs} of twice the float32 bound")
    again = kernel.wkv6_bwd(*args)
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"wkv6_bwd {label}: two calls differ")
    del again
    reps = 5 if S > 1000 else 20
    ms = cuda_time_ms(lambda: kernel.wkv6_bwd(*args), reps, 1)
    dev_ms = graph_time_ms(lambda: kernel.wkv6_bwd(*args), reps)
    fwd_ms = cuda_time_ms(lambda: kernel.wkv6(r, k, v, w, u, s0), reps, 1)
    plain = cuda_time_ms(lambda: ref.wkv6_bwd(*args), 1, 0)
    # per state element and step: 3 to rebuild S (w S + k v; the
    # forward's y is not needed), 3 for G = w G + r dy and 2 for each of
    # the sums of dr, dk, dv and dw: 14.  Per (b, t, h) the bonus terms:
    # v . dy and sum r u k (2 N + 3 N), dr's u k (v . dy) 3 N, dk's
    # (r u)(v . dy) 2 N, dv's dy (sum r u k) 2 N, du's 3 N: 15 N.
    # (the meta route, `ops._meta_bwd`, charges the dry run the kernel's
    # own count, which
    # rebuilds S 2.375 times a step: (145 N^2 + 120 N) / 8, 29% more.)
    n_ops = float(B * S * H * (14 * N * N + 15 * N))
    b, by = bound_ms(nbytes(*[t for t in args if t is not None], *got), n_ops,
                     F32_OPS_PER_S)
    say("kernel", name="wkv6_bwd", case=label,
        shape="B={},S={},H={},N={}".format(*shape), dtype=dtype,
        dsT=with_dsT, abs_err=json.dumps({k: f"{e:.3e}" for k, e in
                                          errs.items()}, separators=(",", ":")),
        bound_frac=f"{frac:.3e}", repeat_bitwise=True, ms=round(ms, 6),
        device_ms=round(dev_ms, 6), fwd_ms=round(fwd_ms, 6),
        plain_ms=round(plain, 6), bound_ms=f"{b:.4e}", bound_by=by,
        bound_share=round(b / dev_ms, 5))
    del args, got, r, k, v, w, u, s0, dy, dsT
    torch.cuda.empty_cache()
    return dict(case=label, shape=shape, dtype=dtype, dsT=with_dsT,
                max_abs_err=max(errs.values()), abs_errs=errs,
                bound_fracs=fracs, ms=ms, device_ms=dev_ms, fwd_ms=fwd_ms,
                plain_ms=plain, bound_ms=b, bound_by=by,
                bound_share=b / dev_ms)


def kernel_backward(report: list) -> None:
    cases = [flash_bwd_case(*c, seed=41 + i)
             for i, c in enumerate(FLASH_BWD_CASES)]
    report.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:84",
        replaces_note="the backward of that kernel's function: the JAX "
                      "package has no backward kernel and differentiates "
                      "src/repro/models/layers.py:113 with jax.grad",
        cases=cases, **{k: cases[0][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}))
    cases = [rglru_bwd_case(*c, seed=51 + i)
             for i, c in enumerate(RGLRU_BWD_CASES)]
    report.append(dict(
        name="rglru_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/rg_lru/csrc/rg_lru.cu",
        replaces="src/repro/kernels/rg_lru/kernel.py:47",
        replaces_note="the backward of that kernel's function: the JAX "
                      "package differentiates its associative scan "
                      "(src/repro/models/layers.py:673) with jax.grad",
        library_ms=None, cases=cases, **{k: cases[0][k] for k in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by")}))
    cases = [wkv6_bwd_case(*c, seed=61 + i)
             for i, c in enumerate(WKV_BWD_CASES)]
    report.append(dict(
        name="wkv6_bwd", route="cuda",
        source="src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6/kernel.py:59",
        replaces_note="the backward of that kernel's function: the JAX "
                      "package has no backward kernel and differentiates "
                      "its plain WKV (src/repro/kernels/rwkv6/ref.py:18, "
                      "jax.checkpoint per chunk) with jax.grad",
        library_ms=None, cases=cases, **{k: cases[0][k] for k in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by")}))


# ----------------------------------------------------------------------
# phase 15: full-width recurrentgemma-2b trains; phase 16: resume
# ----------------------------------------------------------------------

#: step 1's loss and gradients, kernel path against its plain twin (both
#: bf16 weights, the same batch, two microbatches accumulated in float32):
#: |loss difference| at most LOSS_TOL, and for every parameter leaf the
#: relative error ||g_kernel - g_plain|| / ||g_plain|| at most GRAD_TOL;
#: and the kernel path's gradient, over all leaves, no further from the
#: float32 yardstick's (the same weights in float32, plain versions) than
#: GRAD_F32_RATIO times the twin's distance.  The rule of `LOGIT_TOL`,
#: 1.5x the highest sound reading over two seeds, rounded up at two
#: significant digits (scripts/train_grad_control.py, NVIDIA H100 80GB
#: HBM3, 700 W, seeds 88 / 89; a reading repeats to the last bit):
#: recurrentgemma-2b's worst leaf 0.01034 / 0.01445 (attention wq, wk),
#: gemma2-2b's 0.01377 / 0.01454; loss 5.455e-4 / 4.511e-4 apart.  The
#: mutants: the backward without D 0.608 / 0.821 (attention wq), dK and
#: dV from one head of the group 0.996 / 0.990 (wk, wv), the RG-LRU
#: backward's da one step late 0.0383 / 0.0401 (rglru wa): 1.74x above
#: GRAD_TOL at the least.  None moves the loss (the forward is sound).
#: The float32 ratio reads 0.997 / 1.014 sound, 2.92 / 3.47 without D and
#: 18.3 / 19.3 ungrouped; the RG-LRU mutant 0.994 / 1.011 (its error sits
#: in small leaves).  The cap's derivative dropped moves neither model
#: (recurrentgemma has no attention cap; gemma2's scores stay near 1
#: against its cap of 50): phase 14's ``cap_near`` case catches it
LOSS_TOL = 0.00082
GRAD_TOL = 0.022
GRAD_F32_RATIO = F32_DISTANCE_RATIO
#: rwkv6-7b's limits, by the same rule from its own readings over six
#: seeds (scripts/train_grad_control.py --families wkv6 at
#: `RWKV_TRAIN_LAYERS`, NVIDIA H100 80GB HBM3, 700 W, seeds 88-93;
#: gradients against the `GRAD_TWIN` twin): the sound kernels' worst leaf
#: 0.066362 / 0.32659 / 0.058267 / 0.11587 / 0.10017 / 0.069815 (u, wr,
#: u, wk, u, u), loss 1.3065e-4 / 1.0881e-3 / 4.7302e-4 / 5.722e-6 /
#: 4.9877e-4 / 3.9101e-4 from the plain twin's; the mutants: dw dropped
#: 1.0 at every seed (w0's gradient all zero), the adjoint not decayed
#: 124.68-175.01, dk without its bonus 1.0870-3.8146 (u): 2.0x above
#: RWKV_GRAD_TOL at the least.  The float32 ratio reads 0.9794-1.0521
#: sound, under `GRAD_F32_RATIO`.  None moves the loss
RWKV_LOSS_TOL = 0.0017
RWKV_GRAD_TOL = 0.49
#: the twin whose step-1 gradients each model's are held against: the
#: plain versions throughout (the default), or ("backward") the kernels
#: but WKV6's backward, which takes its plain version (`grad_pass`).
#: rwkv6-7b's gradients cannot be held against its plain twin: at this
#: init its lower layers' bf16 gradients move by tens of times their size
#: when any forward exact to float32 rounding rounds a few of its bf16
#: outputs the other way (scripts/wkv6_grad_probe.py, NVIDIA H100 80GB
#: HBM3, 700 W, seeds 88 / 89: the forward kernel, whose y differs from
#: the plain forward's in 0.032% of elements with no bias, moves the worst
#: leaf 101 / 28.9 relative and the float32 ratio to 2.84 / 1.52; the
#: plain forward with its float32 y scaled by 1 +/- 2^-19 before the cast,
#: 0.033% of y rounding the other way, 33.0 / 5.05 and 2.60 / 0.37; by
#: 1 +/- 2^-22 and 2^-16, 7.36 / 66.3 and 7.54 / 87.4, ratios 1.05 / 8.59
#: and 0.58 / 39.0; the backward kernel alone 0.278 / 0.153).  So those
#: distances cannot tell a sound forward kernel from a broken backward;
#: the forward kernel is held instead on the pass's own inputs
#: (`wkv6_path_check`), and its loss against the plain twin's
GRAD_TWIN = {RWKV_ARCH: "backward"}
#: rwkv6-7b trains at full width cut to this depth: the deepest whose peak
#: the dry run reads (``launch/dryrun.py`` ``count_cell`` at phase 15's
#: shape on a (1, 1) mesh) at or below `TRAIN_PEAK_LIMIT` (checked in
#: `rwkv_train_depth`; phase 15's measured peak is held against the read
#: in `dryrun_calibration`); all 32 layers need 151.5 GB at 20 bytes a
#: parameter
RWKV_TRAIN_LAYERS = 13
TRAIN_PEAK_LIMIT = 72e9


def train_limits(arch: str) -> tuple[float, float]:
    """(loss limit, per-leaf gradient limit) of ``arch``'s step-1 checks."""
    if arch == RWKV_ARCH:
        return RWKV_LOSS_TOL, RWKV_GRAD_TOL
    return LOSS_TOL, GRAD_TOL


def rwkv_train_depth(summary: dict) -> int:
    """`RWKV_TRAIN_LAYERS`, checked against the dry run's read: its peak
    at or below `TRAIN_PEAK_LIMIT`, one layer more above it.  The read at
    `RWKV_TRAIN_LAYERS` goes to ``summary`` for `dryrun_calibration`."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh

    cfg = configs.get(RWKV_ARCH)
    peaks = {}
    for n in (RWKV_TRAIN_LAYERS, RWKV_TRAIN_LAYERS + 1):
        rec = dryrun.count_cell(dataclasses.replace(cfg, n_layers=n), "train",
                                TRAIN_B, TRAIN_S,
                                AbstractMesh((1, 1), ("data", "model")),
                                microbatches=TRAIN_MB)
        peaks[n] = rec["memory"]["peak_live_bytes"]
        if n == RWKV_TRAIN_LAYERS:
            summary["train_depth_read"] = rec
    say("lm:train_depth", arch=RWKV_ARCH, full_layers=cfg.n_layers,
        layers=RWKV_TRAIN_LAYERS, limit_gb=TRAIN_PEAK_LIMIT / 1e9,
        est_peak_gb=json.dumps({n: round(b / 1e9, 3) for n, b in
                                peaks.items()}, separators=(",", ":")))
    check(peaks[RWKV_TRAIN_LAYERS] <= TRAIN_PEAK_LIMIT
          < peaks[RWKV_TRAIN_LAYERS + 1],
          f"{RWKV_ARCH}: {RWKV_TRAIN_LAYERS} layers is not the deepest cut "
          f"the dry run reads at or below {TRAIN_PEAK_LIMIT:.0f} bytes "
          f"({peaks})")
    return RWKV_TRAIN_LAYERS


def train_batches(cfg):
    """The two batches the phase alternates: ``make_batch`` steps 0 and 1
    of B=TRAIN_B x TRAIN_S tokens on the card."""
    from repro_torch.data import DataConfig, make_batch
    return [make_batch(cfg, DataConfig(seed=SEED), i, TRAIN_B, TRAIN_S,
                       device="cuda") for i in range(2)]


def train_launches(cfg, steps: int) -> dict:
    """Kernel launches of ``steps`` gradient passes of TRAIN_MB
    microbatches: under remat each layer's forward runs twice (the pass
    and its recomputation in the backward), its backward once."""
    n = {kind: sum(m == kind for m, _ in cfg.layer_plan)
         for kind in ("attn", "local", "rglru", "rwkv")}
    per = steps * TRAIN_MB
    flash = n["attn"] + n["local"]
    return {"flash_attention": 2 * flash * per, "flash_attention_bwd":
            flash * per, "rglru_scan": 2 * n["rglru"] * per,
            "rglru_scan_bwd": n["rglru"] * per,
            "wkv6": 2 * n["rwkv"] * per, "wkv6_bwd": n["rwkv"] * per}


def grad_distances(a: list, b: list) -> tuple[list, float]:
    """Per leaf ||a - b|| / ||b|| (float64 sums) and the same over all
    leaves at once."""
    import torch

    per, num, den = [], 0.0, 0.0
    for x, y in zip(a, b):
        # a leaf with no path to the loss has no gradient: zeros
        x = torch.zeros_like(y) if x is None else x
        y = torch.zeros_like(x) if y is None else y
        d = float(torch.linalg.vector_norm((x.float() - y.float()).ravel(),
                                           dtype=torch.float64)) ** 2
        n = float(torch.linalg.vector_norm(y.float().ravel(),
                                           dtype=torch.float64)) ** 2
        per.append((d / n) ** 0.5 if n > 0 else (0.0 if d == 0 else
                                                 float("inf")))
        num, den = num + d, den + n
    return per, (num / den) ** 0.5


def twin_loss(cfg, params, batch, microbatches: int = TRAIN_MB) -> float:
    """The plain twin's step-1 loss without its gradients: the forward of
    each microbatch through the plain versions under no_grad, averaged as
    `loss_and_grads` averages them."""
    import torch

    from repro_torch.models import model as M

    mb = batch["tokens"].shape[0] // microbatches
    set_pin(True)
    try:
        with torch.no_grad():
            lsum = torch.zeros((), dtype=torch.float32, device="cuda")
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                lsum = lsum + M.loss_fn(params, cfg, part)
            return float(lsum / microbatches)
    finally:
        set_pin(False)


def grad_pass(cfg, params, batch, plain, microbatches: int = TRAIN_MB):
    """(loss, grads, seconds) of one gradient pass (`loss_and_grads`), the
    kernels, the plain versions (``plain`` True) or the kernels but WKV6's
    backward, which takes its plain version (``plain`` "backward": this
    module swaps ``ops._impl`` of WKV6 for the pass)."""
    import torch

    from repro_torch.kernels.rwkv6 import ops as wops
    from repro_torch.kernels.rwkv6 import ref as wref
    from repro_torch.train import loss_and_grads

    impl = wops._impl
    if plain == "backward":
        wops._impl = lambda r: (impl(r)[0], wref.wkv6_bwd)
    set_pin(plain is True)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, grads = loss_and_grads(params, cfg, batch, microbatches)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        set_pin(False)
        wops._impl = impl
    return float(loss), grads, secs


def keep_wkv6_calls(picks) -> tuple[list, object]:
    """Swap WKV6's route for one that keeps the operands and outputs of
    its forward calls numbered in ``picks`` (counted from 0); returns the
    list they go to and a function that restores the route."""
    from repro_torch.kernels.rwkv6 import ops as wops

    impl, seen, n = wops._impl, [], [0]

    def route(r):
        fwd, bwd = impl(r)

        def keep(*a):
            out = fwd(*a)
            if n[0] in picks:
                seen.append((n[0], tuple(t.detach() for t in a),
                             tuple(t.detach() for t in out)))
            n[0] += 1
            return out
        return keep, bwd
    wops._impl = route
    return seen, lambda: setattr(wops, "_impl", impl)


def half_ulp(x):
    """Half a unit in the last place of ``x``'s dtype at |x| (float64)."""
    import torch

    _, e = torch.frexp(x.double())
    return torch.finfo(x.dtype).eps * torch.ldexp(
        torch.ones_like(x, dtype=torch.float64), e - 2)


def wkv6_path_check(seen) -> list:
    """The forward kernel's outputs on the training path's own inputs
    (`keep_wkv6_calls`) against the plain forward on the same inputs: y
    within twice ``ref.f32_error_bound`` (two float32 evaluations) plus
    half a unit in the last place of each (each rounds to y's dtype), the
    final state within twice the bound."""
    import torch

    from repro_torch.kernels.rwkv6 import ref

    rows = []
    for i, a, (y, sT) in seen:
        yp, sp = ref.wkv6(*a)
        yb, sb = ref.f32_error_bound(*(t.float() for t in a[:3]), *a[3:])
        dy = (y.double() - yp.double()).abs()
        y_frac = float((dy / (2 * yb + half_ulp(y) + half_ulp(yp))).max())
        ds = (sT.double() - sp.double()).abs()
        s_frac = float(torch.where(ds == 0, torch.zeros_like(ds),
                                   ds / (2 * sb)).max())
        rows.append(dict(call=i, y_bound_frac=y_frac, state_bound_frac=s_frac,
                         y_differs=float((y != yp).float().mean())))
        del yp, sp, yb, sb, dy, ds
    return rows


def lm_train(summary: dict, kernel_ms: dict, arch: str = LM_ARCH,
             n_layers: int | None = None) -> dict:
    """Phase 15 for ``arch`` at full width (cut to ``n_layers`` layers when
    given).  Returns the launches of the kernel path's runs."""
    import torch

    from repro_torch.optim import AdamWConfig, init_state, tree_map
    from repro_torch.train import TrainConfig, make_train_step

    cfg, params, n_params = full_model(arch, n_layers)
    loss_tol, grad_tol = train_limits(arch)
    key = "" if arch == LM_ARCH else f"_{arch}"
    names = _leaf_names(params)
    batches = train_batches(cfg)
    twin = GRAD_TWIN.get(arch, True)
    lm_reset()
    # step 1's gradients: kernels, the twin (`GRAD_TWIN`), the float32
    # yardstick; the loss against the plain twin's
    # rwkv6: the forward kernel's first, middle and last layer's calls of
    # the first microbatch are kept for `wkv6_path_check`
    picks = ({0, cfg.n_layers // 2, cfg.n_layers - 1} if arch == RWKV_ARCH
             else set())
    seen, restore = keep_wkv6_calls(picks)
    try:
        loss_k, g_k, secs_k = grad_pass(cfg, params, batches[0],
                                        plain=False)
    finally:
        restore()
    grad_launches = lm_launches()
    want = train_launches(cfg, 1)
    check(grad_launches == want,
          f"{arch} train gradient pass launches {grad_launches}, expected "
          f"{want}")
    lm_reset()
    loss_g, g_p, secs_p = grad_pass(cfg, params, batches[0], plain=twin)
    want = {k: 0 if twin is True or k.endswith("_bwd") else n
            for k, n in grad_launches.items()}
    check(lm_launches() == want,
          f"{arch}: the twin launched {lm_launches()}, expected {want}")
    fwd_rows = wkv6_path_check(seen)
    del seen
    for row in fwd_rows:
        say("lm:train_wkv6_fwd", arch=arch,
            **{k: (f"{v:.6g}" if isinstance(v, float) else v)
               for k, v in row.items()})
        check(row["y_bound_frac"] <= 1.0 and row["state_bound_frac"] <= 1.0,
              f"{arch} train: the forward kernel's call {row['call']} parts "
              f"from the plain forward on its inputs by {row} of the bound")
    loss_p = loss_g if twin is True else twin_loss(cfg, params, batches[0])
    per_twin, all_twin = grad_distances(g_k, g_p)
    p32 = tree_map(lambda t: t.float(), params)
    loss_f, g_f, secs_f = grad_pass(cfg, p32, batches[0], plain=True,
                                    microbatches=1)
    del p32
    per_k32, all_k32 = grad_distances(g_k, g_f)
    per_p32, all_p32 = grad_distances(g_p, g_f)
    del g_f, g_p
    torch.cuda.empty_cache()
    worst = max(range(len(per_twin)), key=lambda i: per_twin[i])
    ratios = [k / p if p > 0 else 1.0 for k, p in zip(per_k32, per_p32)]
    worst_ratio = max(range(len(ratios)), key=lambda i: ratios[i])
    grads_line = dict(
        grad_twin="plain" if twin is True else "wkv6_plain_backward",
        loss=loss_k, twin_loss=loss_p, f32_loss=loss_f,
        loss_diff=abs(loss_k - loss_p), loss_tol=loss_tol,
        grad_rel_err_max=per_twin[worst], grad_rel_err_max_leaf=names[worst],
        grad_rel_err_all=all_twin, grad_tol=grad_tol,
        f32_dist_kernels=all_k32, f32_dist_twin=all_p32,
        f32_ratio=all_k32 / all_p32, f32_ratio_tol=GRAD_F32_RATIO,
        f32_leaf_ratio_max=ratios[worst_ratio],
        f32_leaf_ratio_max_leaf=names[worst_ratio],
        grad_pass_s=secs_k, twin_grad_pass_s=secs_p, f32_grad_pass_s=secs_f)
    say("lm:train_grads", arch=arch, layers=cfg.n_layers, B=TRAIN_B,
        S=TRAIN_S, microbatches=TRAIN_MB,
        **{k: (f"{v:.6g}" if isinstance(v, float) else v)
           for k, v in grads_line.items()})
    summary["train_grads" + key] = dict(
        grads_line, wkv6_fwd=fwd_rows, per_leaf={n: dict(twin=a, k32=b, p32=c) for n, a, b, c
                              in zip(names, per_twin, per_k32, per_p32)})
    check(abs(loss_k - loss_p) <= loss_tol,
          f"{arch} train step-1 loss {loss_k} against the twin's {loss_p}")
    check(per_twin[worst] <= grad_tol,
          f"{arch} train grads: {names[worst]} differs from the twin by "
          f"{per_twin[worst]} relative (limit {grad_tol})")
    check(all_k32 <= GRAD_F32_RATIO * all_p32,
          f"{arch} train grads: the kernel path is {all_k32} from float32, "
          f"the twin {all_p32} (limit {GRAD_F32_RATIO}x)")
    del g_k
    torch.cuda.empty_cache()

    # four steps of AdamW on the alternating batches
    opt_cfg = AdamWConfig(**TRAIN_OPTS.get(arch, TRAIN_OPT))
    tcfg = TrainConfig(optimizer=opt_cfg, microbatches=TRAIN_MB)
    step = make_train_step(cfg, tcfg, device="cuda")
    opt = init_state(tcfg.optimizer, params)
    torch.cuda.reset_peak_memory_stats()
    lm_reset()
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, batches[i % 2])
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    # the gradient pass's and the steps' (the twins' runs are comparisons)
    launches = {k: n + grad_launches[k] for k, n in lm_launches().items()}
    want = train_launches(cfg, 1 + TRAIN_STEPS)
    tokens = TRAIN_B * TRAIN_S
    mean_ms = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    per_step = train_launches(cfg, 1)
    kern_ms = {k: per_step[k] * kernel_ms[k] for k in kernel_ms}
    say("lm:train", arch=arch, layers=cfg.n_layers, params=n_params,
        B=TRAIN_B, S=TRAIN_S, microbatches=TRAIN_MB, steps=TRAIN_STEPS,
        losses=",".join(f"{x:.6f}" for x in losses),
        step1_loss_equals_grad_pass=losses[0] == loss_k,
        step_ms=",".join(f"{x:.3f}" for x in step_ms),
        tokens_per_s=round(tokens / (mean_ms / 1e3), 1),
        peak_gb=round(peak / 1e9, 3),
        launches=json.dumps(launches, separators=(",", ":")),
        kernels_ms_per_step=json.dumps(
            {k: round(v, 3) for k, v in kern_ms.items()},
            separators=(",", ":")),
        kernels_share=round(sum(kern_ms.values()) / mean_ms, 4))
    summary["train" + key] = dict(
        layers=cfg.n_layers, losses=losses, step_ms=step_ms, peak_bytes=peak,
        tokens_per_s=tokens / (mean_ms / 1e3), launches=launches,
        kernels_ms_per_step=kern_ms,
        kernels_share=sum(kern_ms.values()) / mean_ms)
    check(all(x == x and abs(x) < float("inf") for x in losses),
          f"{arch} train losses not finite: {losses}")
    check(losses[2] < losses[0],
          f"{arch} train loss did not fall on the repeated batch: {losses}")
    check(launches == want,
          f"{arch} train launches {launches}, expected {want}")
    check(int(opt["step"]) == TRAIN_STEPS, "AdamW step count")
    del params, opt, batches
    torch.cuda.empty_cache()
    return launches


def _leaf_names(params) -> list:
    """Leaf names in `optim.tree_leaves` order ("layers/3/rglru/wa")."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return [n for k in sorted(node) for n in walk(node[k],
                                                          f"{prefix}{k}/")]
        if isinstance(node, list):
            return [n for i, v in enumerate(node)
                    for n in walk(v, f"{prefix}{i}/")]
        return [prefix[:-1]]
    return walk(params, "")


CKPT_LAYERS = 3


def ckpt_resume(summary: dict) -> dict:
    """Phase 16: recurrentgemma-2b cut to one pattern triple takes two
    steps, saves, restores; a third step from the restored state equals,
    bit for bit, a third step from the live state.  Returns its launches."""
    import shutil
    import tempfile

    import torch

    from repro_torch.ckpt import restore, save
    from repro_torch.optim import AdamWConfig, init_state, tree_leaves
    from repro_torch.train import TrainConfig, make_train_step

    cfg, params, n_params = full_model(LM_ARCH, CKPT_LAYERS)
    batches = train_batches(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT),
                       microbatches=TRAIN_MB)
    step = make_train_step(cfg, tcfg, device="cuda")
    opt = init_state(tcfg.optimizer, params)
    lm_reset()
    for i in range(2):
        params, opt, _ = step(params, opt, batches[i])
    tmp = tempfile.mkdtemp(prefix="repro_ckpt_")
    try:
        t = time.perf_counter()
        save(tmp, 2, params, opt, extra={"arch": cfg.name})
        save_s = time.perf_counter() - t
        size = sum(os.path.getsize(os.path.join(tmp, f))
                   for f in os.listdir(tmp))
        t = time.perf_counter()
        at, tree = restore(tmp, device="cuda")
        restore_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(at == 2, f"restored step {at}")
    same_restore = all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves({"params": params, "opt": opt}), tree_leaves(tree)))
    live_p, live_o, live_m = step(params, opt, batches[0])
    live = [t.clone() for t in tree_leaves({"params": live_p,
                                            "opt": live_o})]
    del params, opt, live_p, live_o
    torch.cuda.empty_cache()
    res_p, res_o, res_m = step(tree["params"], tree["opt"], batches[0])
    resumed = tree_leaves({"params": res_p, "opt": res_o})
    same = [torch.equal(a, b) for a, b in zip(live, resumed)]
    launches = lm_launches()
    say("lm:ckpt_resume", arch=LM_ARCH, layers=CKPT_LAYERS, params=n_params,
        bytes=size, save_s=round(save_s, 3), restore_s=round(restore_s, 3),
        restored_bitwise=same_restore,
        loss_live=f"{float(live_m['loss']):.9g}",
        loss_resumed=f"{float(res_m['loss']):.9g}",
        leaves_bitwise=f"{sum(same)}/{len(same)}")
    summary["ckpt_resume"] = dict(bytes=size, save_s=save_s,
                                  restore_s=restore_s, leaves=len(same),
                                  leaves_bitwise=sum(same))
    check(same_restore, "checkpoint: restored state differs from the saved")
    check(float(live_m["loss"]) == float(res_m["loss"]) and all(same),
          "checkpoint: the resumed third step differs from the live one")
    del live, resumed, res_p, res_o, tree
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phase 17: sharding and launch
# ----------------------------------------------------------------------

#: the dry run's cells: every architecture at train_4k on the single-pod
#: 16 x 16 mesh, written where `job_from_roofline` reads them
DRYRUN_SHAPE = "train_4k"
#: jobs built from the records: one per step count and architecture, and
#: a sweep job per architecture that runs those trainings side by side.
#: A chain of single-task stages never reaches the builder's scan: each
#: stage is a part of its own (the DAG is totally ordered), spans that
#: part's whole horizon and so runs longer than `LONG_K` ticks, which the
#: builder probes on the host; the sweep's trainings of 1 : 2 : 4 lengths
#: share one part, and the shorter two are scanned
DRYRUN_STEPS = (25, 50, 100)
DRYRUN_SLICES = 32
#: the dry run's read peak against phase 15's measured one
#: (``max_memory_allocated``): within this share either way
CALIBRATION_TOL = 0.05


#: the dry run's child process: its limit in seconds, and the worker
#: processes it counts the cells in (the card's host has 8 cores)
DRYRUN_TIMEOUT = 480
DRYRUN_JOBS = 4


def dryrun_records(out_dir: str) -> list:
    """The dry run of every architecture at `DRYRUN_SHAPE` on the
    single-pod mesh, written fresh under ``out_dir`` by the dry run's CLI
    in a child process: it owns the fake process group of the mesh's 256
    ranks (this process keeps its NCCL group) and is shown no card."""
    from repro_torch import configs
    from repro_torch.launch import report

    os.makedirs(out_dir, exist_ok=True)
    cells = [(a, DRYRUN_SHAPE) for a in configs.ARCH_IDS]
    for arch, shape in cells:
        path = os.path.join(out_dir, f"{arch}_{shape}_single.json")
        if os.path.exists(path):
            os.remove(path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--shape", DRYRUN_SHAPE, "--mesh", "single", "--out", out_dir,
         "--jobs", str(DRYRUN_JOBS)],
        env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT)
    count_s = time.perf_counter() - t
    check(proc.returncode == 0, f"the dry run's child exited "
                                f"{proc.returncode}: {proc.stdout[-2000:]}"
                                f"{proc.stderr[-2000:]}")
    recs = []
    for arch, shape in cells:
        with open(os.path.join(out_dir, f"{arch}_{shape}_single.json")) as f:
            recs.append(json.load(f))
    bad = [r["arch"] for r in recs if "error" in r]
    check(not bad, f"dry run failed for {bad}: "
                   f"{[r.get('error') for r in recs if 'error' in r]}")
    for line in report.roofline_table(recs).splitlines()[2:]:
        print(f"dryrun:row {line}", flush=True)
    coll: dict = {}
    for r in recs:
        for kind, b in r["collectives"]["bytes_by_kind"].items():
            coll[kind] = coll.get(kind, 0.0) + b
    say("launch:dryrun", cells=len(recs), mesh="single", shape=DRYRUN_SHAPE,
        count_s=round(count_s, 3), child=True,
        torch=",".join(sorted({r["torch"] for r in recs})),
        cell_count_s=",".join(str(r["count_s"]) for r in recs),
        dominant=",".join(r["roofline"]["dominant"] for r in recs),
        collective_s=",".join(f"{r['roofline']['collective_s']:.6f}"
                              for r in recs),
        coll_bytes=json.dumps({k: coll[k] for k in sorted(coll)},
                              separators=(",", ":")),
        fits_80g=sum(r["memory"]["fits_80g"] for r in recs),
        peak_gb=",".join(f"{r['memory']['peak_live_bytes'] / 1e9:.3f}"
                         for r in recs),
        memory_depth=",".join(r["memory"]["depth"] for r in recs),
        out=os.path.relpath(out_dir, ROOT))
    return recs


def dryrun_jobs(recs: list, out_dir: str) -> list:
    """Jobs from the records (`job_from_roofline`), one per architecture
    and `DRYRUN_STEPS` entry, each train stage's seconds and HBM share read
    from its architecture's record; then one sweep job per architecture:
    warmup, its trainings side by side, eval after all of them, export."""
    from repro_torch.launch import TPUJob, job_from_roofline
    from repro_torch.launch.roofline import HBM_PER_DEVICE

    jobs, sweeps = [], []
    for a, rec in enumerate(recs):
        rl = rec["roofline"]
        mine = []
        for steps in DRYRUN_STEPS:
            job = job_from_roofline(f"job-{rec['arch']}-{steps}", rec["arch"],
                                    out_dir, steps=steps, group=a % 2)
            train = job.stages[1]
            want = max(rl["compute_s"], rl["memory_s"],
                       rl["collective_s"]) * steps
            check(train["seconds"] == want and train["hbm"] == min(
                rec["memory"]["peak_live_bytes"] / HBM_PER_DEVICE, 0.9),
                  f"{job.name}: its train stage is not its record's")
            mine.append(job)
        first, k = mine[0].stages, len(mine)
        stages = ([dict(first[0])]
                  + [dict(j.stages[1], deps=[0]) for j in mine]
                  + [dict(first[2], deps=list(range(1, k + 1))),
                     dict(first[3], deps=[k + 1])])
        sweeps.append(TPUJob(f"sweep-{rec['arch']}", rec["arch"], stages,
                             group=a % 2))
        jobs += mine
    return jobs + sweeps


def schedule_dryrun_jobs(jobs: list, summary: dict) -> dict:
    """`schedule_cluster` of the jobs with dagps in exact mode (the scan
    and the wave) and routed mode (the eligibility op) on the card, each
    against its numpy-pinned twin by ``repr``.  Returns the kernel runs'
    launches, counted from 0 for each run."""
    from repro_torch.kernels.placement_scan import kernel
    from repro_torch.launch import schedule_cluster
    from repro_torch.sim import clear_schedule_cache

    launches = {k: 0 for k in kernel.launch_counts()}
    for mode in ("exact", "routed"):
        def run():
            return schedule_cluster(jobs, n_slices=DRYRUN_SLICES, seed=SEED,
                                    matcher_mode=mode, profile=True,
                                    device="cuda")
        clear_schedule_cache()
        kernel.reset_launches()
        t = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t
        got = kernel.launch_counts()
        wave = ("match_wave.numpy" if mode == "exact"
                else "machines_with_candidates.numpy")
        twin, twin_wall = pinned_numpy(run, need=("scan.numpy", wave))
        mine = decisions(res)
        check(len(res.jobs) == len(jobs),
              f"launch:{mode}: {len(res.jobs)} of {len(jobs)} jobs completed")
        check(mine == decisions(twin),
              f"launch:{mode}: decisions differ from the numpy twin")
        for k, v in got.items():
            launches[k] += v
        say(f"launch:schedule_{mode}", jobs=len(jobs), slices=DRYRUN_SLICES,
            identical_to_numpy=True, wall_s=round(wall, 3),
            numpy_wall_s=round(twin_wall, 3),
            launches=json.dumps(got, separators=(",", ":")),
            makespan=mine["makespan"], jain_60=mine["jain_60"])
        summary[f"launch_schedule_{mode}"] = dict(
            wall_s=wall, numpy_wall_s=twin_wall, launches=got,
            decisions=mine)
    for name in ("scan_bitmaps", "match_wave_walk", "heartbeat_eligible"):
        check(launches[name] > 0,
              f"launch: {name} never launched scheduling the dry-run jobs")
    return launches


@contextlib.contextmanager
def nccl_mesh():
    """Phases 17 and 18's NCCL process group of world size 1 on a
    FileStore and its (1, 1) debug mesh, both torn down on leaving."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    tmp = tempfile.mkdtemp(prefix="repro_nccl_")
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            yield make_debug_mesh(1, 1, device_type="cuda")
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def nccl_mesh_psum(summary: dict, mesh) -> None:
    """Full-width recurrentgemma-2b distributed on the (1, 1) NCCL mesh, and
    `compressed_psum_tree` over "data" on a float32 gradient tree of the
    same shapes drawn from `SEED`: each leaf bitwise
    ``dequantize(quantize_int8(g))``, which world size 1 must give."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.optim import (compressed_psum_tree, dequantize,
                                   quantize_int8, tree_leaves, tree_map)

    cfg, params, n_params = full_model(LM_ARCH)
    t = time.perf_counter()
    dtree = distribute_tree(params, mesh, cfg)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t
    leaves = tree_leaves(dtree)
    check(all(isinstance(x, DTensor) and tuple(x.placements)
              == (Replicate(), Replicate()) for x in leaves),
          "distribute_tree: a leaf is not replicated on the mesh")
    check(all(torch.equal(x.to_local(), y) for x, y in
              zip(leaves, tree_leaves(params))),
          "distribute_tree: a local part differs from its leaf")
    del dtree, leaves
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device="cuda") * 1e-3, params)
    del params
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = compressed_psum_tree(grads, "data", mesh)
    end.record()
    torch.cuda.synchronize()
    psum_ms = start.elapsed_time(end)
    same = [torch.equal(o, dequantize(*quantize_int8(g)).to(g.dtype))
            for o, g in zip(tree_leaves(out), tree_leaves(grads))]
    n_bytes = sum(g.numel() * g.element_size() for g in tree_leaves(grads))
    del grads, out
    torch.cuda.empty_cache()
    say("launch:nccl", backend="nccl", world_size=1, mesh="data=1,model=1",
        arch=LM_ARCH, params=n_params, distribute_s=round(dist_s, 3),
        psum_leaves=len(same), psum_bitwise=f"{sum(same)}/{len(same)}",
        psum_bytes=n_bytes, psum_tree_ms=round(psum_ms, 3))
    summary["launch_nccl"] = dict(distribute_s=dist_s, psum_ms=psum_ms,
                                  psum_bytes=n_bytes, leaves=len(same),
                                  bitwise=sum(same))
    check(all(same), "compressed_psum_tree at world size 1 is not "
                     "dequantize(quantize_int8(g)) bitwise")


def dryrun_calibration(summary: dict) -> None:
    """The dry run's read at phase 15's shape on a (1, 1) abstract mesh
    beside the peak phase 15 measured (``max_memory_allocated``), within
    `CALIBRATION_TOL`, for both trainings: recurrentgemma-2b (counted
    here) and rwkv6-7b at `RWKV_TRAIN_LAYERS` (`rwkv_train_depth`'s read);
    recurrentgemma-2b's FLOPs over phase 15's mean step wall as achieved
    TFLOP/s, a reading."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh

    cfg = configs.get(LM_ARCH)
    rec = dryrun.count_cell(cfg, "train", TRAIN_B, TRAIN_S,
                            AbstractMesh((1, 1), ("data", "model")),
                            microbatches=TRAIN_MB)
    out = {}
    for arch, rec, train in (
            (LM_ARCH, rec, summary["train"]),
            (RWKV_ARCH, summary["train_depth_read"],
             summary[f"train_{RWKV_ARCH}"])):
        measured = train["peak_bytes"]
        mem = rec["memory"]
        est = mem["peak_live_bytes"]
        step_ms = sum(train["step_ms"][1:]) / (len(train["step_ms"]) - 1)
        flops = rec["roofline"]["flops_per_device"]
        say("launch:calibration", arch=arch, layers=train["layers"],
            B=TRAIN_B, S=TRAIN_S, microbatches=TRAIN_MB,
            read_peak_gb=round(est / 1e9, 3),
            measured_peak_gb=round(measured / 1e9, 3),
            peak_ratio=round(est / measured, 4), tol=CALIBRATION_TOL,
            memory=json.dumps({k: v for k, v in mem.items()
                               if k.endswith("_bytes")}, separators=(",", ":")),
            peak_at=json.dumps(mem["peak_at"], separators=(",", ":")),
            largest=json.dumps([[b["bytes"], b["shape"], b["dtype"],
                                 b["site"] or b["node"]]
                                for b in mem["largest"][:3]],
                               separators=(",", ":")),
            flops=f"{flops:.6e}", step_ms=round(step_ms, 3),
            achieved_tflops=round(flops / (step_ms / 1e3) / 1e12, 3),
            count_s=rec["count_s"])
        out[arch] = dict(read_peak_bytes=est, measured_peak_bytes=measured,
                         flops=flops, step_ms=step_ms, memory=mem,
                         roofline=rec["roofline"])
    summary["launch_calibration"] = out
    for arch, row in out.items():
        est, measured = row["read_peak_bytes"], row["measured_peak_bytes"]
        check(abs(est - measured) <= CALIBRATION_TOL * measured,
              f"{arch}: the dry run reads a peak of {est} bytes, not within "
              f"{CALIBRATION_TOL:.0%} of the measured {measured}")


def launch_phase(summary: dict, mesh) -> dict:
    """Phase 17 (``mesh``: `nccl_mesh`'s).  Returns the schedule runs'
    kernel launches."""
    import torch

    torch.cuda.empty_cache()
    t = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out", "dryrun")
    recs = dryrun_records(out_dir)
    launches = schedule_dryrun_jobs(dryrun_jobs(recs, out_dir), summary)
    nccl_mesh_psum(summary, mesh)
    dryrun_calibration(summary)
    say("lm:phase", arch="launch", wall_s=round(time.perf_counter() - t, 3))
    return launches


# ----------------------------------------------------------------------
# phase 18: the sharded programs on the (1, 1) NCCL mesh
# ----------------------------------------------------------------------

#: phase 18 serves and trains gemma2-2b whole (26 layers) on the mesh;
#: the earlier paths' models take one gradient pass there at full width,
#: cut to these depths (recurrentgemma-2b: one pattern triple)
SHARDED_ARCH = "gemma2_2b"
SHARDED_CUTS = (("recurrentgemma_2b", 3), ("rwkv6_7b", 2))
SHARDED_STEPS = 2
#: the MoE families at full width on the mesh, cut to these depths (depth
#: alone): deepseek-moe-16b's dense first layer and one MoE layer of 64
#: experts, top-6, 2 shared; mixtral-8x7b's first layer, 8 experts of
#: width 14,336
SHARDED_MOE = (("deepseek_moe_16b", 2), ("mixtral_8x7b", 1))


def local(x):
    """A DTensor's local part (on a (1, 1) mesh, the whole tensor)."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def on_mesh(mesh, cfg, B: int):
    """The activation rules of ``cfg`` at batch ``B`` on ``mesh``."""
    from repro_torch.launch.sharding import activation_rules
    from repro_torch.models.sharding import activation_sharding
    return activation_sharding(mesh, activation_rules(mesh, B,
                                                      n_kv=cfg.n_kv_heads))


def synced(fn):
    """(fn(), seconds on the host clock, the card synchronized)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def first_unequal(a: list, b: list, names: list):
    """The name of the first leaf where ``a`` and ``b`` differ, or None."""
    import torch
    for x, y, n in zip(a, b, names):
        if (x is None) != (y is None) or (x is not None
                                          and not torch.equal(x, y)):
            return n
    return None


def sharded_serve(mesh, summary: dict) -> dict:
    """gemma2-2b: prefill (last position) of B=GEN_B x GEN_S and
    ``greedy_generate`` of GEN_NEW tokens with the parameters and prompt
    distributed on the mesh, then the same calls on plain tensors: the
    logits and tokens bitwise equal.  Returns the mesh run's launches."""
    import torch

    from repro_torch.launch.sharding import distribute_batch, distribute_tree
    from repro_torch.models import model as M
    from repro_torch.serve import greedy_generate

    cfg, params, n_params = full_model(SHARDED_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab, (GEN_B, GEN_S), generator=gen,
                           device="cuda")
    dparams = distribute_tree(params, mesh, cfg, fsdp=False)
    dprompt = distribute_batch({"tokens": prompt}, mesh)["tokens"]
    lm_reset()
    with on_mesh(mesh, cfg, GEN_B):
        (logits_d, _), pre_d = synced(lambda: M.prefill(
            dparams, cfg, {"tokens": dprompt}, last_only=True))
        toks_d, gen_d = synced(lambda: greedy_generate(
            dparams, cfg, dprompt, GEN_NEW, device="cuda"))
    launches = lm_launches()
    pre, step = path_launches(cfg)
    want = {k: 2 * pre[k] + GEN_NEW * step[k] for k in pre}
    check(launches == want,
          f"sharded serve launches {launches}, expected {want}")
    logits_d, toks_d = local(logits_d), local(toks_d)
    lm_reset()
    (logits_p, _), pre_p = synced(lambda: M.prefill(
        params, cfg, {"tokens": prompt}, last_only=True))
    toks_p, gen_p = synced(lambda: greedy_generate(
        params, cfg, prompt, GEN_NEW, device="cuda"))
    twin = lm_launches()
    same_logits = bool(torch.equal(logits_d, logits_p))
    same_tokens = bool(torch.equal(toks_d, toks_p))
    line = dict(prefill_s=pre_d, plain_prefill_s=pre_p, generate_s=gen_d,
                plain_generate_s=gen_p, logits_bitwise=same_logits,
                tokens_identical=same_tokens)
    say("sharded:serve", arch=SHARDED_ARCH, layers=cfg.n_layers,
        params=n_params, B=GEN_B, S0=GEN_S, n_new=GEN_NEW,
        **{k: (round(v, 3) if isinstance(v, float) else v)
           for k, v in line.items()},
        launches=json.dumps(launches, separators=(",", ":")),
        plain_launches=json.dumps(twin, separators=(",", ":")))
    summary["sharded_serve"] = dict(line, launches=launches,
                                    plain_launches=twin)
    check(bool(torch.isfinite(logits_d).all()), "sharded prefill: non-finite")
    check(same_logits, f"{SHARDED_ARCH}: the sharded prefill's last-position "
                       "logits differ from the plain-tensor call's")
    check(same_tokens, f"{SHARDED_ARCH}: greedy_generate's tokens on the mesh "
                       "differ from the plain-tensor call's")
    del params, dparams, logits_d, logits_p
    torch.cuda.empty_cache()
    return launches


def sharded_grads(mesh, cfg, params, batch, arch: str,
                  summary: dict) -> dict:
    """One gradient pass (`loss_and_grads`, TRAIN_MB microbatches) with the
    parameters and batch distributed on the mesh, then on plain tensors:
    the loss and every gradient leaf bitwise equal.  Returns the mesh
    pass's launches."""
    import torch

    from repro_torch.launch.sharding import distribute_batch, distribute_tree
    from repro_torch.train import loss_and_grads

    names = _leaf_names(params)
    dparams = distribute_tree(params, mesh, cfg)
    dbatch = distribute_batch(batch, mesh)
    lm_reset()
    with on_mesh(mesh, cfg, TRAIN_B):
        (loss_d, g_d), secs_d = synced(lambda: loss_and_grads(
            dparams, cfg, dbatch, TRAIN_MB))
    launches = lm_launches()
    want = train_launches(cfg, 1)
    check(launches == want,
          f"{arch} sharded gradient pass launches {launches}, expected "
          f"{want}")
    loss_d = local(loss_d)
    g_d = [None if g is None else local(g) for g in g_d]
    del dparams, dbatch
    lm_reset()
    (loss_p, g_p), secs_p = synced(lambda: loss_and_grads(
        params, cfg, batch, TRAIN_MB))
    same_loss = bool(torch.equal(loss_d, loss_p))
    bad = first_unequal(g_d, g_p, names)
    line = dict(loss=float(loss_d), plain_loss=float(loss_p),
                loss_bitwise=same_loss, grads_bitwise=bad is None,
                first_unequal_leaf=bad, leaves=len(names),
                grad_pass_s=secs_d, plain_grad_pass_s=secs_p)
    say("sharded:grads", arch=arch, layers=cfg.n_layers, B=TRAIN_B,
        S=TRAIN_S, microbatches=TRAIN_MB,
        **{k: (round(v, 3) if isinstance(v, float) and k.endswith("_s")
               else v) for k, v in line.items()},
        launches=json.dumps(launches, separators=(",", ":")))
    summary["sharded_grads_" + arch] = dict(line, launches=launches)
    check(same_loss, f"{arch}: the sharded pass's loss {float(loss_d)} is "
                     f"not the plain-tensor pass's {float(loss_p)} bitwise")
    check(bad is None, f"{arch}: the sharded pass's gradient of {bad} "
                       "differs from the plain-tensor pass's")
    del g_d, g_p
    torch.cuda.empty_cache()
    return launches


def sharded_pair_bytes(cfg) -> tuple[float, float]:
    """(the dry run's read peak of gemma2-2b's step at phase 15's shape on
    a (1, 1) mesh, plus the parameters kept from the mesh's steps while
    the plain-tensor steps run; the step's own peak)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.optim import tree_leaves

    rec = dryrun.count_cell(cfg, "train", TRAIN_B, TRAIN_S,
                            AbstractMesh((1, 1), ("data", "model")),
                            microbatches=TRAIN_MB)
    peak = rec["memory"]["peak_live_bytes"]
    params = sum(t.numel() * t.element_size()
                 for t in tree_leaves(dryrun.meta_params(cfg)))
    return peak + params, peak


def sharded_train(mesh, summary: dict) -> dict:
    """gemma2-2b whole: step 1's gradient pass bitwise against plain tensors
    (`sharded_grads`), then SHARDED_STEPS AdamW steps on the mesh and the
    same steps on plain tensors from the same weights (run after, not
    beside): losses and parameters bitwise equal; each side's step wall
    on the host clock, the mesh's peak memory.  Returns the mesh runs'
    launches."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.sharding import distribute_batch, distribute_tree
    from repro_torch.optim import AdamWConfig, init_state, tree_leaves
    from repro_torch.train import TrainConfig, make_train_step

    pair, step_peak = sharded_pair_bytes(configs.get(SHARDED_ARCH))
    say("sharded:memory", arch=SHARDED_ARCH, est_step_peak_gb=round(
        step_peak / 1e9, 3), est_pair_gb=round(pair / 1e9, 3),
        limit_gb=TRAIN_PEAK_LIMIT / 1e9)
    check(pair <= TRAIN_PEAK_LIMIT,
          f"{SHARDED_ARCH}: the dry run puts the mesh and plain steps at "
          f"{pair / 1e9:.1f} GB, above {TRAIN_PEAK_LIMIT / 1e9:.0f}: cut "
          "the depth")
    cfg, params, n_params = full_model(SHARDED_ARCH)
    batches = train_batches(cfg)
    launches = sharded_grads(mesh, cfg, params, batches[0], SHARDED_ARCH,
                             summary)
    tcfg = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT),
                       microbatches=TRAIN_MB)
    step = make_train_step(cfg, tcfg, device="cuda")

    def steps(p, opt, batch_list):
        losses, walls = [], []
        for i in range(SHARDED_STEPS):
            (p, opt, m), secs = synced(lambda: step(p, opt, batch_list[i % 2]))
            losses.append(local(m["loss"]))
            walls.append(secs)
        return p, losses, walls

    # the mesh's steps update ``params`` in place (their local parts)
    dparams = distribute_tree(params, mesh, cfg)
    dopt = distribute_tree(init_state(tcfg.optimizer, params), mesh, cfg)
    dbatches = [distribute_batch(b, mesh) for b in batches]
    torch.cuda.reset_peak_memory_stats()
    lm_reset()
    with on_mesh(mesh, cfg, TRAIN_B):
        _, losses_d, walls_d = steps(dparams, dopt, dbatches)
    peak = torch.cuda.max_memory_allocated()
    step_launches = lm_launches()
    want = train_launches(cfg, SHARDED_STEPS)
    check(step_launches == want,
          f"{SHARDED_ARCH} sharded steps launch {step_launches}, expected "
          f"{want}")
    del dparams, dopt, dbatches
    torch.cuda.empty_cache()
    _, p0, _ = full_model(SHARDED_ARCH)
    opt = init_state(tcfg.optimizer, p0)
    lm_reset()
    p0, losses_p, walls_p = steps(p0, opt, batches)
    del opt
    same_losses = all(bool(torch.equal(a, b))
                      for a, b in zip(losses_d, losses_p))
    bad = first_unequal(tree_leaves(params), tree_leaves(p0),
                        _leaf_names(params))
    line = dict(losses=",".join(f"{float(x):.6f}" for x in losses_d),
                losses_bitwise=same_losses, params_bitwise=bad is None,
                first_unequal_leaf=bad,
                step_s=",".join(f"{x:.3f}" for x in walls_d),
                plain_step_s=",".join(f"{x:.3f}" for x in walls_p),
                host_cost_s=round(walls_d[-1] - walls_p[-1], 3),
                peak_gb=round(peak / 1e9, 3))
    say("sharded:train", arch=SHARDED_ARCH, layers=cfg.n_layers,
        params=n_params, B=TRAIN_B, S=TRAIN_S, microbatches=TRAIN_MB,
        steps=SHARDED_STEPS, **line,
        flash_attention=step_launches["flash_attention"]
        + launches["flash_attention"],
        flash_attention_bwd=step_launches["flash_attention_bwd"]
        + launches["flash_attention_bwd"])
    summary["sharded_train"] = dict(line, step_walls=walls_d,
                                    plain_step_walls=walls_p,
                                    peak_bytes=peak, launches=step_launches)
    check(same_losses, f"{SHARDED_ARCH}: the sharded steps' losses differ "
                       "from the plain-tensor steps'")
    check(bad is None, f"{SHARDED_ARCH}: after the steps {bad} differs "
                       "between the mesh and plain tensors")
    del params, p0, batches
    torch.cuda.empty_cache()
    return {k: launches[k] + step_launches[k] for k in launches}


def sharded_moe(mesh, arch: str, n_layers: int, summary: dict) -> dict:
    """An MoE family at full width and ``n_layers`` layers: its prefill
    (B=GEN_B x GEN_S, last-position logits and the decode state) and its
    gradient pass on plain tensors twice each, bitwise on repeat (the
    combine adds each token's contributions in a fixed order,
    ``layers.moe_combine``); then the prefill with the parameters and
    prompt on the mesh, its dispatch and combine in their regions, bitwise
    against the plain call, its routing against the plain call's; then
    the gradient pass on the mesh (`sharded_grads`).  Returns the mesh
    runs' launches."""
    import torch

    from repro_torch.launch.sharding import distribute_batch, distribute_tree
    from repro_torch.models import model as M
    from repro_torch.train import loss_and_grads

    cfg, params, n_params = full_model(arch, n_layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab, (GEN_B, GEN_S), generator=gen,
                           device="cuda")
    batch = train_batches(cfg)[0]

    def prefill(p, tokens):
        with RouteLog() as log:
            logits, st = M.prefill(p, cfg, {"tokens": tokens},
                                   last_only=True)
        return [local(t) for t in [logits, *_leaves(st)]], log.calls

    (pre_p, routes_p), pre_p_s = synced(lambda: prefill(params, prompt))
    pre_names = ["logits"] + [f"state{i}" for i in range(len(pre_p) - 1)]
    again = first_unequal(pre_p, prefill(params, prompt)[0], pre_names)
    names = _leaf_names(params)
    (l1, g1), (l2, g2) = (loss_and_grads(params, cfg, batch, TRAIN_MB)
                          for _ in range(2))
    grads_again = (None if torch.equal(l1, l2) else "loss") or \
        first_unequal(g1, g2, names)
    del g1, g2
    torch.cuda.empty_cache()
    dparams = distribute_tree(params, mesh, cfg, fsdp=False)
    dprompt = distribute_batch({"tokens": prompt}, mesh)["tokens"]
    lm_reset()
    with on_mesh(mesh, cfg, GEN_B):
        (pre_d, routes_d), pre_d_s = synced(lambda: prefill(dparams,
                                                            dprompt))
    launches = lm_launches()
    want = path_launches(cfg)[0]
    check(launches == want,
          f"{arch} sharded prefill launches {launches}, expected {want}")
    bad = first_unequal(pre_d, pre_p, pre_names)
    routing = routing_diff(cfg, routes_d, routes_p)
    del dparams, pre_d, pre_p
    line = dict(prefill_repeats=again is None,
                grads_repeat=grads_again is None,
                prefill_bitwise=bad is None, first_unequal=bad,
                prefill_s=pre_d_s, plain_prefill_s=pre_p_s, **routing)
    say("sharded:moe", arch=arch, layers=cfg.n_layers, params=n_params,
        B=GEN_B, S=GEN_S,
        **{k: (round(v, 3) if isinstance(v, float) else v)
           for k, v in line.items()},
        launches=json.dumps(launches, separators=(",", ":")))
    summary["sharded_moe_" + arch] = dict(line, launches=launches)
    check(again is None, f"{arch}: a second prefill on plain tensors "
                         f"differs in {again}")
    check(grads_again is None, f"{arch}: a second gradient pass on plain "
                               f"tensors differs in {grads_again}")
    check(bad is None, f"{arch}: the sharded prefill's {bad} differs from "
                       "the plain-tensor call's")
    for k, v in sharded_grads(mesh, cfg, params, batch, arch,
                              summary).items():
        launches[k] += v
    del params, batch
    torch.cuda.empty_cache()
    return launches


def sharded_phase(summary: dict, mesh) -> dict:
    """Phase 18: the sharded programs (prefill, decode, the train step) on
    the (1, 1) mesh of `nccl_mesh`, every placement ``Replicate()``, each
    held bitwise against the same call on plain tensors.  Returns the mesh
    runs' launches (the plain-tensor twins' are comparisons)."""
    import torch

    t = time.perf_counter()
    say("sharded:mesh", backend="nccl", world_size=1, mesh="data=1,model=1",
        families=",".join((SHARDED_ARCH,) + tuple(
            a for a, _ in SHARDED_CUTS + SHARDED_MOE)))
    torch.cuda.empty_cache()
    launches = sharded_serve(mesh, summary)
    for k, v in sharded_train(mesh, summary).items():
        launches[k] += v
    for arch, n_layers in SHARDED_CUTS:
        cfg, params, _ = full_model(arch, n_layers)
        batch = train_batches(cfg)[0]
        for k, v in sharded_grads(mesh, cfg, params, batch, arch,
                                  summary).items():
            launches[k] += v
        del params, batch
        torch.cuda.empty_cache()
    for arch, n_layers in SHARDED_MOE:
        for k, v in sharded_moe(mesh, arch, n_layers, summary).items():
            launches[k] += v
    wall = time.perf_counter() - t
    say("lm:phase", arch="sharded", wall_s=round(wall, 3),
        launches=json.dumps(launches, separators=(",", ":")))
    summary["sharded_launches"] = launches
    return launches


def main() -> int:
    started = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.placement_scan import kernel
    from repro_torch.kernels.rg_lru import kernel as rglru_kernel
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.sim import online_mix_workload

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi0 = smi[0] if smi else "nvidia-smi unavailable"
    families = (kernel, flash_kernel, rglru_kernel, wkv_kernel)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(families)) as pool:   # one nvcc per source
        paths = list(pool.map(lambda fam: fam.build(verbose=True), families))
    build_s = time.perf_counter() - t0
    for fam in families:
        fam.lib()
    say("device", name=name, count=torch.cuda.device_count(),
        build_s=round(build_s, 3),
        libraries=",".join(os.path.relpath(p, ROOT) for p in paths))
    print(smi0, flush=True)

    report: list = []
    summary: dict = {}
    kernel_scan(report)
    kernel_resident(report)
    kernel_eligible(report)
    heartbeat_masks_op(summary)
    kernel_wave(report)
    say("kernels", names=",".join(r["name"] for r in report))

    dags = online_mix_workload(N_JOBS, seed=SEED)
    path_launches = [
        main_path("exact", "exact", dags, ("scan.cuda", "match_wave.cuda"),
                  summary, rebuild=True),
        # the later runs reuse the (bit-identical) schedules phase 3 built
        main_path("routed", "routed", dags,
                  ("machines_with_candidates.cuda",), summary),
        # four shards of 512 machines: per-shard eligibility calls, in the
        # routed wave and in the numpy wave's threaded fan-out
        main_path("routed_4shards", "routed", dags,
                  ("machines_with_candidates.cuda",), summary,
                  shard_machines=512),
        main_path("exact_4shards_numpy_wave", "exact", dags,
                  ("machines_with_candidates.cuda",), summary,
                  pin="match_wave=numpy", shard_machines=512)]
    # phase 3, continued: build workers and the jit backend (their launches
    # run in worker processes or on the resident route: not counted below)
    build_workers_path(dags, summary)
    jit_path(dags, summary)
    # phase 3, continued: the scheduler service, each path with the launch
    # counts set to 0 just before it and read just after
    path_launches += [service_path(summary), service_tcp_path(summary),
                      service_chaos_path(summary)]
    launches = {k: sum(p[k] for p in path_launches)
                for k in path_launches[0]}
    # the scan's line reports the case the path launched most often
    shapes = scan_shapes(summary)
    top = sorted(shapes.items(), key=lambda kv: -kv[1])
    say("scan_shapes", launches=sum(shapes.values()),
        top=json.dumps([[list(k), v] for k, v in top[:8]],
                       separators=(",", ":")))
    classes: dict = {}
    for shape, n in shapes.items():
        key = shape_class(*shape)
        classes[key] = classes.get(key, 0) + n
    scan = report[0]
    best = max(scan["cases"],
               key=lambda c: classes.get(shape_class(*c["shape"]), 0))
    scan.update({k: best[k] for k in ("max_abs_err", "ms", "device_ms",
                                      "plain_ms", "bound_ms", "bound_by")})
    scan["case"] = best["case"]

    kernel_flash(report)
    kernel_rglru(report)
    lm_params, lm_runs, lm_walls = {}, {}, {}
    for arch in SERVED + FAMILIES:
        if arch == RWKV_ARCH:
            kernel_wkv6(report)
        t = time.perf_counter()
        if arch in SERVED:
            cfg, params, lm_params[arch] = full_model(arch)
            lm_runs[arch] = dict(
                generate=lm_generate(arch, cfg, params, summary,
                                     turns=arch == LM_ARCH),
                serve=lm_serve(arch, cfg, params, summary))
            del params
        else:
            lm_runs[arch] = dict(prefill=lm_family(arch, summary, lm_params))
        torch.cuda.empty_cache()
        lm_walls[arch] = time.perf_counter() - t
        say("lm:phase", arch=arch, wall_s=round(lm_walls[arch], 3))
    for k in lm_launches():
        launches[k] = sum(run[k] for runs in lm_runs.values()
                          for run in runs.values())
    summary["lm_launches"], summary["lm_walls"] = lm_runs, lm_walls
    # phases 14-16: the backward kernels, training, checkpoint resume
    t = time.perf_counter()
    kernel_backward(report)
    # each kernel's ms a call at a training microbatch (phase 14's first
    # cases: the backward and the forward with its log-sum-exp)
    kernel_ms = {}
    for r in report:
        if r["name"].endswith("_bwd"):
            kernel_ms[r["name"]] = r["ms"]
            kernel_ms[r["name"][:-len("_bwd")]] = r["cases"][0]["fwd_ms"]
    train_runs = [lm_train(summary, kernel_ms),
                  lm_train(summary, kernel_ms, RWKV_ARCH,
                           rwkv_train_depth(summary)),
                  ckpt_resume(summary)]
    for k in lm_launches():
        launches[k] += sum(run[k] for run in train_runs)
    lm_walls["train"] = time.perf_counter() - t
    say("lm:phase", arch="train", wall_s=round(lm_walls["train"], 3))
    with nccl_mesh() as mesh:
        # phase 17: the dry run, its jobs scheduled on the card, the mesh
        t = time.perf_counter()
        for k, v in launch_phase(summary, mesh).items():
            launches[k] += v
        lm_walls["launch"] = time.perf_counter() - t
        # phase 18: the sharded programs on the mesh
        t = time.perf_counter()
        for k, v in sharded_phase(summary, mesh).items():
            launches[k] += v
        lm_walls["sharded"] = time.perf_counter() - t
    for r in report:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0, f"{r['name']} never launched on the path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels_line = {"kernels": [
        dict({k: r[k] for k in keys},
             **{k: r[k] for k in ("device_ms", "library_worst",
                                  "replaces_note") if k in r})
        for r in report]}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "build_s": build_s,
                   "n_jobs": N_JOBS, "n_machines": N_MACHINES,
                   "lm_params": lm_params,
                   "kernels": report, "scan_shapes": [
                       [list(k), v] for k, v in top], "paths": summary},
                  f, indent=1, default=str)
    say("smoke", wall_s=round(time.perf_counter() - started, 3),
        lm_phases_s=round(sum(lm_walls.values()), 3))
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def stop_forkserver() -> None:
    """Stop the build pools' forkserver, if phase 3 started one, so that
    the script leaves no process running."""
    svc = sys.modules.get("repro_torch.core.buildsvc")
    if svc is not None:
        svc.stop_forkserver()


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        rc = 1
    finally:
        stop_forkserver()
    sys.exit(rc)
