"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--rows N] [--train Q] [--serve Q]

Phases, each printed as it runs:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the build of every hand-written kernel from the sources in this
     checkout (one nvcc per library, all started together: the masked top-k,
     the decode kernel for f32/bf16 caches, and for int8 caches), with its
     seconds;
  3. the masked L2 top-k against its plain PyTorch version on the card at
     the ANN path's shapes (B from 1 to 256), with its path (streaming or
     tiled), query tile and splits, its time, the plain version's, the
     library yardstick's and the bound; a row alone (streaming) equals the
     same row in a tiled batch of 64 or 256 bitwise, and repeated calls
     are bitwise equal;
  3b. the flash-decode attention kernel likewise, at qwen3-14b's heads over
     B in {1, 8, 32} x S in {2088, 32768} x {bf16, f32} with ragged lengths,
     and at the reference tests' shapes, with the chunk size at each S; one
     CUDA kernel per call (torch.profiler), repeated calls bitwise equal,
     row independence (bitwise) and never reading past a row's length (NaN
     there);
  3c. the decode kernel's sliding window and softcap against the plain
     version at gemma2's heads (KV 4, GQ 2, dh 256) and qwen3's (8, 5, 128),
     B in {1, 8}, S = 8192, bf16 and f32, windows 4096 and 100, softcap 0
     and 50, lengths below and above the window; NaN outside each row's
     window, repeated calls, a row alone against the batch and calls after
     other windows on one cached workspace all give the clean results
     bitwise; kernel, plain and SDPA (window as a boolean mask; none with a
     softcap) times beside the bound of min(len, window) positions a row;
  3d. the decode kernel's int8 K/V (f32 scales per position and head,
     dequantized to bf16 and to f32) against the plain version at qwen3's
     serving shape (B 8, KV 8, GQ 5, S 2088, dh 128), gemma2's windowed one
     (KV 4, GQ 2, dh 256, S 8192, window 4096, softcap 0 and 50) and
     hymba's (KV 5, GQ 5, dh 64, S 2088, window 1024 and full), ragged
     lengths with window starts off a multiple of 4; NaN scales and garbage
     int8 outside each row's window never reach the output, repeated calls
     and rows alone equal the batch bitwise; the int8 kernel's device ms
     beside the bf16 kernel's at the same shape, the plain version's,
     dequantize_kv + SDPA's (two calls) and the bound of dh + 4 bytes a
     position, head and tensor;
  3f. the bf16 decode kernel against the plain version at the encdec and
     vlm serving shapes: seamless-m4t's cross-attention (B 8, KV 16, GQ 1,
     dh 64, S = F = 1,024, every row full), its self-attention (S 128,
     ragged) and internvl2's (KV 8, GQ 8, dh 128, S 2,320, ragged);
     repeated calls bitwise equal, one CUDA kernel a call; kernel, plain
     and SDPA times beside the bound; then its split rows: one rank's 2 of
     a cache's 4 KV heads read in place (kv0 0 and 2; B 4, GQ 2, dh 256,
     S 8,192, window 4,096, softcap 0 and 50, bf16 and int8) against the
     plain version on the same heads, bitwise the whole-cache launch's
     heads, NaN in the other heads never read; the split launch beside the
     whole-cache launch, the plain version, the library and the bound of
     the rank's bytes;
  4. the filtered-ANN main path through its public entry points on the
     arxiv dataset at the paper's full size (2.14M x 384): build -> fit ->
     query / batch_query -> ground_truth; then 256 queries under one shared
     predicate through the exact executors in one call, each row equal to
     its query alone;
  3e. on phase 4's engine: 256 of its queries, each under its own mask on
     the rows the pre executor scans, alone (streaming path) equal to the
     same row in a batch of 64 (tiled path), ids and distances bitwise; and
     l2_topk (a clean engine's ground_truth) against the kernel's rows, the
     ranks the two order otherwise printed with their distances (up to
     ties);
  4b. DNF: 64 Ors of 2-3 of phase 4's served predicates (overlapping, one
     with a repeated term, one a permutation of another) through query()
     and through batch_query() mixed with conjunctions, on the phase-4
     engine; every id passes its union once, batch rows equal query rows,
     all-exact unions equal ground truth up to ties, the permuted Or hits
     the plan cache; the clause plan mix, latency per union size, and how
     many all-exact unions equal one fused_masked_topk over the union mask
     bitwise;
  4c. a routed engine at the same size, backends flat, ivf, ivfpq and
     acorn (the ivf backend shares the engine's IVF): first the flat
     backend below TINY_N rows on the card (the kernel against the numpy
     scan); build seconds and memory per backend, fit on the first 8 of
     phase 4's training queries (8 routing classes raced per query; ACORN's
     host search makes a query cost seconds), phase 4's 200 served
     queries and 32 unions served;
     every id passes its predicate once, flat:exact rows and all-exact
     unions equal ground truth up to ties, batch rows equal query rows; the
     served (decision, backend, knob) mix with latencies, each class's
     recall@10 over 16 fixed queries beside its floor (printed, not gated:
     the floors were set on a 5,000-row corpus) with every id passing its
     mask once (gated, every class), and ACORN's device search against its
     host search; then a routing head spanning all 8 classes serves 2 rows
     per class through query() and batch_query() (every backend's routed
     groups, the same row checks); then the routed engine takes 2 % deletes
     and 0.5 % upserts and serves those rows again (no tombstoned id, every
     id passes its predicate once, flat:exact rows equal the live ground
     truth); the engine is freed;
  4d. the live corpus and sharded serving at the same size: a plain engine
     with phase 4's planner, GBM and IVF layout carried, and a 4-shard
     ShardedANNEngine over it on the one card (shards are views of its
     device corpus); a 2 % segment (fresh rows, ids= replacements, exact
     copies of base rows) and tombstones at 2, 5 and 10 % of the base rows
     applied through the sharded engine; at each level phase 4's served
     queries through query() and batch_query() on both engines: no
     tombstoned id, every id passes its predicate once, exact rows equal the
     live ground truth (bitwise) and an independent l2_topk truth (up to
     ties), sharded exact rows equal the central ones bitwise, batch rows
     equal query rows, each copy right after its base row; latency per plan
     against phase 4's, plan mix, post recall and batch QPS printed; shard 2
     stops beating, replan_mesh(3), reshard(3), exact rows again; both
     engines compacted, exact rows equal the live ones through id_map and a
     fresh build's, bitwise; upsert and delete rows/s, compaction s, peak
     memory; everything is freed before phase 6;
  4e. the serving runtime, checkpoints, observability and the fleet at the
     same size, on a plain engine with phase 4's planner, GBM and IVF
     layout carried (phase 4's engine takes no writes): (a) runtime_bench's
     Poisson and bursty traces of 400 reads at 0.5, 2 and 8 x the
     single-request virtual capacity (a pool of 16 of phase 4's served
     predicates, zipf 1.2, k = 10) through OnlineRuntime(max_batch=64,
     max_wait=0.005), each replayed twice: every request answered once,
     equal batches, counters and ids, every id passing its predicate,
     exact rows equal to an l2_topk truth up to ties; measured QPS beside a
     per-request query() loop, VIRTUAL latencies and deadline hit rates,
     the plan mix, the device's idle share over one replay; (b) a trace
     with write_frac 0.1, every batch checked on the spot after its
     launches are counted (no tombstoned id, exact rows equal the live
     ground truth bitwise and an l2_topk live truth up to ties), then
     mutation_state() through the Checkpointer (save, save_async) onto a
     fresh engine: its rows equal the live engine's bitwise; (c) Tracer,
     RecallProbe and OnlineFeedback on one runtime: two cold replays give
     equal span trees, the execute spans' kernel_* attrs add up to how
     far stats()' kernel_dispatch moved, prometheus_text() parses;
     span_summary beside the
     profiler's device-busy time, probe recall, feedback stats, the smem
     budget gauges; (d) fleet_bench's headline: three tenants over an even
     split of the rows, each fitted on 64 of phase 4's training queries,
     FleetRuntime (DRR, admission, autoscale) twice against the shared
     queue: equal replays, exact rows equal each tenant's truth up to ties
     through the reshards, Fleet.save/restore onto fresh collections
     bitwise; quiet tenants' SLO hit rates (virtual) beside fleet_bench's
     targets, scale events, build, fit and reshard seconds; everything is
     freed before phase 6;
  6. LM serving: qwen3-14b at full width and 20 of its 40 layers in bf16
     (random weights from a seed), 16 requests through ServeEngine in 8
     slots; decode launches equal 20 x steps, the kernel equals its plain version on the
     model's own cache, the device's idle share of a decode step;
  6b. the same for gemma2-2b (26 layers, 13 with a 4096 window, softcaps
     50 and 30) with prompts of 4,200-8,000 tokens and max_len 8192: decode
     launches equal 26 x steps, the kernel against its plain version on a
     local and a global layer of the model's cache, each one's device time;
  6c. the same for olmoe-1b-7b (16 layers of 64 experts, top 8, capacity
     factor 1.25) with prompts of 256-2048 tokens: launches equal 16 x steps,
     the (token, expert) assignments dropped per prefill batch, the decode
     step beside the bound of every expert's weights and of 8 active ones;
  6d. hymba-1.5b (32 layers of attention beside a Mamba head, a 1,024
     window but on layers 0, 15 and 31) at full width and depth in bf16:
     16 requests in two batches of 8 equal-length prompts (1,536 and 2,048
     tokens), 32 new tokens, 8 slots, max_len 2088; launches equal 32 x
     steps, the kernel against its plain version on a local and a global
     layer; the step beside its bound (weights, K/V, the Mamba state);
  6e. xlstm-1.3b (48 blocks: 6 groups of 1 sLSTM + 7 mLSTM) likewise, with
     6d's traffic: no decode_attention launch; the bound counts the mLSTM
     state read and written (1.41 GB each way at 8 slots);
  6f. gemma2-2b with the int8 KV cache on 6b's first 8 requests, 16 new
     tokens: launches equal 26 x steps, the kernel against its plain
     version on a local and a global layer of the int8 cache; the step, the
     kernel's ms per step and the cache's GB beside 6b's, and the share of
     tokens equal to 6b's (not gated);
  7. RAG: RetrievalAugmentedServer over the phase-6 model and the phase-4
     engine; every id passes its predicate, exact plans equal ground truth;
  8. fp32 exactness at full width and depth 4: batch tokens equal solo
     tokens, and served tokens equal the teacher-forced argmax except at
     near-ties;
  8b. the same for gemma2-2b (prompts of 4,100-4,600 tokens, past its
     window) and olmoe-1b-7b at capacity factor 8 (the reference's
     reduced() choice: no token drops);
  8c. the same for hymba-1.5b at depth 4 (layer 0 global, three 1,024
     windows) on 4 prompts of 1,100 tokens and xlstm-1.3b at depth 8 (one
     group) on 4 of 600 (no multiple of the 256-step chunk), equal-length
     batches; qwen3-14b at depth 4 with the int8 cache, batch = solo only
     (teacher forcing never reads the quantised cache);
  12. seamless-m4t-large-v2 (24 encoder + 24 decoder layers, d_model
     1,024) at full width and depth in bf16 through Model.prefill and
     Model.decode_step (ServeEngine serves token prompts only): 16 requests
     of 1,024 stub frames (N(0, 1) from a numpy seed) in two batches of 8,
     prompts of 4-32 tokens, 64 new, max_len 128; decode launches equal
     48 x steps (self- and cross-attention in each layer), every logit
     finite and every token in the vocabulary, the kernel against its plain
     version on layer 0's self and cross K/V; prefill s and the encoder's
     share by CUDA events, the step beside decode_step_bounds (which the
     script checks against a hand count before it first uses the card),
     idle share, CUDA kernels and kernel ms a step (self and cross);
  12b. internvl2-76b at full width and 8 of its 80 layers (all 80 are 141
     GB of bf16 weights): 8 requests of 256 stub patches and prompts of
     256-2,048 tokens, 16 new, max_len 2,320 (the lengths count the
     prefix); launches equal 8 x steps; the same figures;
  12c. fp32 identities at full width: seamless at 4 + 4 layers, internvl2
     at 2, 4 ragged requests each, 16 new: batch tokens equal solo tokens
     and the teacher-forced argmax (frames or patches included) but at
     near-ties;
  10. training (after every earlier model and engine is freed): 10a
     gemma2-2b at full width, 2 layers, fp32: Model.loss's ce equals the
     full-logits CE, and grad_accum 2 equals 1 (loss, first moments); 10b
     gemma2-2b at full width and depth, bf16 compute over fp32 masters, 12
     AdamW steps on TokenPipeline batches of 8 x 1,024 tokens: finite
     losses and grad norms, the loss falling, neither kernel launched; the
     median step beside its bound, tokens/s, peak memory, the profiler's
     idle share and CUDA kernels a step, the forward and optimizer shares;
  9. the serve CLI in-process (repro_torch.launch.serve.main): ann-trace
     over 200,000 rows with 4 shards and the recall probe (the snapshot has
     the reference CLI's keys, masked_l2_topk launched), then --mode lm for
     gemma2-2b, olmoe-1b-7b, hymba-1.5b and xlstm-1.3b (every request its
     tokens); then the train CLI (repro_torch.launch.train.main, hymba-1.5b
     reduced, 8 steps, a checkpoint every 4) over the local mesh (a 1-rank
     NCCL group, FSDP2): 8 losses within 1e-6 of the plain one-device
     step's over the same batches, then a clean resume on the same
     directory;
  11. qwen3-32b at full width and all 64 layers in bf16 (after every
     earlier model is freed): first, with nothing allocated, the dry-run
     (repro_torch.launch.dryrun on a 1 x 1 mesh, fake tensors) predicts the
     decode step's argument bytes and temp bytes and the prefill's peak,
     beside the analytic memory term and decode_step_bounds; then 4
     requests (prompts of 256-2,048 tokens, 16 new) through ServeEngine in
     8 slots, max_len 2,088, with phase 6's gates (64 decode launches a
     step, the kernel against its plain version on the model's cache); the
     bytes allocated by init plus the cache within 1 % of the predicted
     argument bytes (gated: the dry-run counts the model's own bytes); the
     peak within 10 % of the traced prefill's predicted peak (gated: the
     prediction of fit); the peak against the decode step's prediction and
     the card's memory, the decode step against the analytic memory term and
     decode_step_bounds, and phase 10's train step against analytic_cost
     (printed, not gated);
  13. tensor-parallel training (after phase 11, with every earlier model
     freed): gemma2-2b at full width and 13 of its 26 layers in fp32 (TF32 off),
     TokenPipeline(vocab 256,000, seq 512, batch 2, seed 0), 3 AdamW steps
     at lr 3e-4, first in one process (make_train_step), then in two
     spawned processes both on cuda:0 over make_custom_mesh(1, 2, "cuda")
     on a gloo group (NCCL refuses two ranks on one device; FSDP2's
     1-rank data axis runs on gloo too), which start while the one-process
     run trains; gated: each rank's losses and grad norms within 1e-4
     relative of the one-process run's, 4,096 seeded elements of every
     leaf within 2 x lr a step (params) or 1e-4 of the leaf's largest
     value (m, v), all but 1e-4 of the sampled params within 1e-5 (a gate
     that the initial params, a rank with no update, must fail), each
     leaf's fp64 sum within its count times 1e-5 (params) or the moments'
     band, each rank's allocated state within 1 % of the dry-run's state
     bytes on a (1, 2) mesh, no
     kernel launched; printed: the step ms of both runs (the two-process
     step is gloo through the host, not tensor parallelism over NVLink),
     each rank's peak, the phase's seconds;
  13b. tensor-parallel serving by phase 13's two ranks after their
     training: gemma2-2b at full width and all 26 layers in fp32, built
     whole from one seed (one rank at a time) and cut over the (1, 2)
     model axis (attention on 2 of 4 KV heads a rank, the MLP and the
     256,000-token vocab split), 2 requests of 1,024 and 256 tokens, 8
     new, max_len 1,040, through ServeEngine (cut from 4 requests and 16
     new when the script passed 1,080 s); the baseline is this process
     serving the same requests on the whole model (while the ranks start);
     gated: each rank's logits at every step within 1e-4 of the step's max
     |logit|, greedy tokens equal, 4,096 sampled elements of the cache's k
     and of v within 1e-5 (x max(1, max |sample|)), 26 decode_attention
     launches a decode step on each rank and in the baseline, no
     masked_l2_topk, the kernel equal to its plain version over each
     one's heads of its cache; printed: prefill and decode-step walls of
     both, peak GB a rank, the phase's seconds;
  5. one JSON line listing every kernel, then the card line, then the
     result line {"ok": true, "device": {...}}.

Each path's kernel launch counts are set to 0 just before it and read
just after it (phases 4, 4b, 4c, 4d, 4e, 6, 6b-6f, 7, 9, 11, 12, 12b, 13b and each of
13b's ranks; 4c's routed serving, its
spanning-head serving and its live serving each; 4d and 4e each as a
whole, ground truth and rebuilds included, and their serving runs alone:
in 4e the runtime's own batch_query calls, never the checks of them);
masked_l2_topk's launches in the kernels line are the sum over phases 4,
4b, 4c, 4d and 4e (serving runs), decode_attention's over phases 6,
6b-6f (int8 calls included), 11, 12, 12b and 13b (the baseline and both
ranks); training (10 and 13's ranks) launches neither.  Any failed check raises, so the script
exits non-zero and prints no result.  It needs a CUDA card and the repo's
``src/`` beside it, and imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL = ATOL = 2e-4        # distance band of the reference's kernel tests
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12   # fp32 outside the tensor cores, dense
QWEN = "qwen3-14b"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int, expect=None):
    """(device ms per call, CUDA kernels per call): the kernels' self time
    and count under torch.profiler over reps warm calls.  Back-to-back event
    timing of a call whose device work is shorter than its host-side enqueue
    measures the enqueue; this does not.  The profiler now and then drops
    kernel records, which only lowers the count (and the time): a window
    that saw fewer than `expect` kernels per call (by default, none at
    all) is profiled again, up to five times, and the window that saw the
    most kernels is returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        per_call = sum(e.count for e in ka) / reps
        busy = sum(e.self_device_time_total for e in ka)
        if best is None or per_call > best[1]:
            best = (busy / 1e3 / reps, per_call)
        if per_call >= (expect if expect is not None else 1 / reps):
            break
    return best


def distance_band(q, d):
    """How far two fp32 evaluations of max(|q|^2 + |x|^2 - 2 q.x, 0) may
    differ for a query q and a distance d: the reference's 2e-4 band plus
    the cancellation of the expansion form, ~sqrt(dim) roundings of terms
    the size of |q|^2 + |x|^2 (about 2|q|^2 near the query)."""
    import numpy as np

    q2 = float(np.dot(q, q))
    return ATOL + RTOL * np.abs(d) + 4.0 * np.sqrt(q.size) * 2.0 ** -24 * 2.0 * q2


def same_up_to_ties(q, ids_a, d_a, ids_b, d_b) -> bool:
    """Two (1, k) top-k answers for query q agree: distances within the
    band, and any id in one but not the other sits at the k-th distance (a
    tie there, up to the band)."""
    import numpy as np

    fin = np.isfinite(d_b)
    if not np.array_equal(fin, np.isfinite(d_a)):
        return False
    if not np.all(np.abs(d_a[fin] - d_b[fin]) <= distance_band(q, d_b[fin])):
        return False
    diff = set(ids_a[0][ids_a[0] >= 0]) ^ set(ids_b[0][ids_b[0] >= 0])
    if not diff:
        return True
    kth = d_b[fin].max()
    near = np.concatenate([d_a[0][np.isin(ids_a[0], list(diff))],
                           d_b[0][np.isin(ids_b[0], list(diff))]])
    return bool(np.all(np.abs(near - kth) <= distance_band(q, kth)))


# ----------------------------------------------------------------------
# phase 2: build every kernel
# ----------------------------------------------------------------------
def build_kernels() -> dict:
    from repro_torch.kernels import masked_l2
    from repro_torch.kernels.decode_attention import build_int8_library, build_library

    builders = {"masked_l2_topk": masked_l2.build_library, "decode_attention": build_library,
                "decode_attention (int8)": build_int8_library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futs = {name: pool.submit(fn) for name, fn in builders.items()}
        libs = {name: f.result() for name, f in futs.items()}
    secs = time.perf_counter() - t0
    for name, lib in libs.items():
        print(f"[build] {name}: {lib.relative_to(ROOT)}")
    print(f"[build] {len(libs)} libraries of 2 kernels built in {secs:.2f} s", flush=True)
    return libs


# ----------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ----------------------------------------------------------------------
def kernel_checks(n_full: int, d: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.index.flat import l2_topk
    from repro_torch.kernels import masked_l2
    from repro_torch.kernels.masked_l2 import BIG, masked_l2_topk_cuda
    from repro_torch.kernels.ref import masked_l2_topk_ref

    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = masked_l2.load_library()
    for qt in (1, 8) + masked_l2.TILED_QT:      # the wrapper's plan mirrors the .cu
        for k in (1, 10, 128):
            check(lib.masked_l2_topk_smem(qt, d, k) == masked_l2.smem_bytes(qt, d, k),
                  f"masked_l2_topk shared memory qt={qt} k={k}: .cu and plan differ")
    g = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn((n_full, d), generator=g, device=dev)
    rows = {}
    max_err = 0.0
    for n in (n_full, 1 << 19, 16):
        x = corpus[:n]
        # the main path hands the kernel a ~half-passing mask over the full
        # corpus and an all-passing one over a gathered subset
        mask = (torch.rand(n, generator=g, device=dev) < 0.5) if n == n_full \
            else torch.ones(n, dtype=torch.bool, device=dev)
        n_pass = int(mask.sum())
        for b in ((1, 8, 16, 32, 64, 128, 256) if n == n_full else (1, 8, 64, 256)):
            q = torch.randn((b, d), generator=g, device=dev)
            pd, pi = masked_l2_topk_ref(q, x, mask, 128)
            for k in (1, 10, 128):
                plan = masked_l2.plan(b, n, d, k, n_sms)
                kd, ki = masked_l2_topk_cuda(q, x, mask, k)
                torch.cuda.synchronize()
                rd, ri = pd[:, :k], pi[:, :k]
                err = float((kd - rd).abs().max())
                close = torch.allclose(kd, rd, rtol=RTOL, atol=ATOL)
                agree = float((ki == ri).float().mean())
                check(close and agree > 0.95,
                      f"masked_l2_topk B={b} N={n} k={k} ({plan.path}): err {err} agree {agree}")
                max_err = max(max_err, err)
                if k != 10 and not (k == 128 and n == 16):
                    continue
                kk = min(k, n)
                reps = 3 if n == n_full and b >= 128 else 10
                ms = cuda_ms(lambda: masked_l2_topk_cuda(q, x, mask, k), reps)
                plain = cuda_ms(lambda: masked_l2_topk_ref(q, x, mask, k), 2 if n == n_full else 5)
                lib_ms = cuda_ms(lambda: l2_topk(q, x, kk, mask), 2 if n == n_full else 5)
                bytes_ = 4 * b * d + n + 4 * n_pass * d + 8 * b * k
                flops = 2 * b * n_pass * d + 2 * n_pass * d
                bound = 1e3 * max(bytes_ / H100_BYTES_PER_S, flops / H100_FP32_FLOPS)
                by = "bytes" if bytes_ / H100_BYTES_PER_S >= flops / H100_FP32_FLOPS else "operations"
                rows[(b, n, k)] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=bound,
                                       bound_by=by, max_abs_err=err, agree=agree, path=plan.path,
                                       qt=plan.qt, splits=plan.splits)
                print(f"[kernel] masked_l2_topk B={b} N={n} d={d} k={k} pass={n_pass}: "
                      f"{plan.path} path (QT {plan.qt}, {plan.splits} splits): "
                      f"kernel {ms:.4f} ms, plain {plain:.4f} ms, l2_topk {lib_ms:.4f} ms, "
                      f"bound {bound:.6g} ms ({by}), kernel / bound {ms / bound:.3f}, "
                      f"kernel / l2_topk {ms / lib_ms:.3f}, max_abs_err {err:.3g}, "
                      f"id agreement {agree:.4f}", flush=True)
    # all masked, a ragged last tile, padding never returned, lowest-id ties,
    # splits with no passing row: on the streaming path (B=8, a few
    # thousand rows) and on the tiled one (B=256, more than TILED_MIN_N)
    for b, n_e, n_r in ((8, 4096, 513), (256, 1 << 15, masked_l2.TILED_MIN_N + 129)):
        x = corpus[:n_e]
        q = torch.randn((b, d), generator=g, device=dev)
        path = masked_l2.plan(b, n_e, d, 10, n_sms).path
        check(path == ("streaming" if b == 8 else "tiled"), f"B={b} N={n_e} took the {path} path")
        kd, ki = masked_l2_topk_cuda(q, x, torch.zeros(n_e, dtype=torch.bool, device=dev), 10)
        check(bool((ki == -1).all()) and bool((kd == BIG).all()), f"all-masked case B={b}")
        kd, ki = masked_l2_topk_cuda(q, x[:n_r], torch.ones(n_r, dtype=torch.bool, device=dev), 128)
        rd, ri = masked_l2_topk_ref(q, x[:n_r], torch.ones(n_r, dtype=torch.bool, device=dev), 128)
        check(bool((ki < n_r).all()) and bool((ki >= 0).all())
              and float((ki == ri).float().mean()) > 0.95
              and torch.allclose(kd, rd, rtol=RTOL, atol=ATOL), f"ragged tail rows B={b} N={n_r}")
        half = n_e // 2
        dup = torch.cat([x[:half], x[:half]])            # row i and i + half tie
        ones = torch.ones(n_e, dtype=torch.bool, device=dev)
        kd, ki = masked_l2_topk_cuda(q, dup, ones, 10)
        rd, ri = masked_l2_topk_ref(q, dup, ones, 10)
        check(torch.allclose(kd, rd, rtol=RTOL, atol=ATOL)
              and bool((ki[:, 0::2] < half).all())
              and torch.equal(ki[:, 1::2], ki[:, 0::2] + half)
              and torch.equal(kd[:, 1::2], kd[:, 0::2]), f"ties go to the lowest id B={b}")
        sparse = torch.zeros(n_e, dtype=torch.bool, device=dev)
        sparse[n_e // 3: n_e // 3 + 300] = True           # most splits pass no row
        kd, ki = masked_l2_topk_cuda(q, x, sparse, 10)
        rd, ri = masked_l2_topk_ref(q, x, sparse, 10)
        check(float((ki == ri).float().mean()) > 0.95 and bool((ki >= n_e // 3).all())
              and bool((ki < n_e // 3 + 300).all()) and torch.allclose(kd, rd, rtol=RTOL, atol=ATOL),
              f"sparse mask B={b}: splits with no passing row")
    # row independence: a row alone (B=1, streaming) equals, bitwise, the
    # same row in a batch of 64 or 256 (tiled); repeated calls are bitwise equal
    for n, batch, picks in ((n_full, 64, (0, 9, 37, 63)), (n_full, 256, (0, 1, 100, 255)),
                            (1 << 19, 256, (0, 1, 100, 255))):
        mask = (torch.rand(n, generator=g, device=dev) < 0.5) if n == n_full \
            else torch.ones(n, dtype=torch.bool, device=dev)
        qb = torch.randn((batch, d), generator=g, device=dev)
        bd, bi = masked_l2_topk_cuda(qb, corpus[:n], mask, 10)
        path = masked_l2.plan(batch, n, d, 10, n_sms).path
        for r in picks:
            sd, si = masked_l2_topk_cuda(qb[r:r + 1].clone(), corpus[:n], mask, 10)
            check(torch.equal(sd[0], bd[r]) and torch.equal(si[0], bi[r]),
                  f"N={n}: row {r} alone differs from the same row in a batch of {batch} ({path})")
        if batch == 256:
            for _ in range(2):
                ad, ai = masked_l2_topk_cuda(qb, corpus[:n], mask, 10)
                check(torch.equal(ad, bd) and torch.equal(ai, bi),
                      f"N={n}: a repeated B=256 call differs")
    print("[kernel] all-masked, ragged tail, lowest-id ties, empty splits (streaming B=8 and "
          "tiled B=256); row independence "
          "(bitwise, B=1 against B=64 and 256 at N=2.14M, B=256 at N=2^19); repeated B=256 "
          "calls bitwise equal: ok", flush=True)
    del corpus
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": max_err}


# ----------------------------------------------------------------------
# phase 4: the main path
# ----------------------------------------------------------------------
def main_path(n_rows: int, n_train: int, n_serve: int, batch: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import EngineConfig, FilteredANNEngine, gen_queries, recall_at_k
    from repro_torch.data import make_dataset
    from repro_torch.index.flat import l2_topk
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ds = make_dataset("arxiv", "full" if n_rows == 2_140_000 else str(n_rows), seed=0)
    q_all, preds, _ = gen_queries(ds.vectors, ds.cat, ds.num, n_train + n_serve,
                                  kinds=ds.filter_kinds, seed=1)
    print(f"[main] arxiv {ds.vectors.shape} and {len(preds)} queries made in "
          f"{time.perf_counter() - t0:.1f} s (host set-up)", flush=True)

    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    t0 = time.perf_counter()
    eng = FilteredANNEngine(ds.vectors, ds.cat, ds.num, EngineConfig(device="cuda")).build()
    print(f"[main] build {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in eng.build_time_.items()), flush=True)

    qt, pt = q_all[:n_train], preds[:n_train]
    qs, ps = q_all[n_train:], preds[n_train:]
    eng.fit(qt, pt, k=10)
    mix = np.bincount(eng.labels_, minlength=2)
    print(f"[main] fit {eng.build_time_['fit']:.2f} s on {n_train} queries: labels "
          f"pre {mix[0]} / post {mix[1]}, planner CV AUC {eng.planner.val_auc_:.4f}, "
          f"chosen L2 {eng.planner.best_l2_}", flush=True)

    k = 10
    l0 = ops.kernel_launches()["masked_l2_topk"]
    served = [eng.query(qs[i], ps[i], k) for i in range(n_serve)]
    l1 = ops.kernel_launches()["masked_l2_topk"]
    t0 = time.perf_counter()
    batched = []
    for s in range(0, n_serve, batch):
        batched += eng.batch_query(qs[s : s + batch], ps[s : s + batch], k)
    batch_s = time.perf_counter() - t0
    launches = ops.kernel_launches()
    dispatch = ops.dispatch_counts()
    n_exact = sum(r.plan.strategy in ("pre", "ipre") for r in served)
    n_batches = -(-n_serve // batch)
    print(f"[main] masked_l2_topk launches: {l1 - l0} over {n_serve} query() calls "
          f"({n_exact} exact plans), {launches['masked_l2_topk'] - l1} over {n_batches} "
          f"batch_query() calls of {batch}", flush=True)

    # truth with distances, for the up-to-ties comparison
    vd = eng.vectors_dev
    def truth(i):
        m = torch.as_tensor(ps[i].eval(eng.cat, eng.num), device=vd.device)
        d, t = l2_topk(torch.as_tensor(qs[i:i + 1], device=vd.device), vd, k, m)
        return d.cpu().numpy(), t.cpu().numpy()

    by_plan: dict = {}
    recalls = []
    for i, (r, br) in enumerate(zip(served, batched)):
        check(r.result.ids.shape == (1, k) and np.isfinite(r.result.dists[r.result.ids >= 0]).all(),
              f"query {i}: malformed result")
        check(np.array_equal(r.result.ids, br.result.ids),
              f"query {i}: batch_query ids differ from query ids")
        check(np.array_equal(eng.ground_truth(qs[i], ps[i], k).shape, (1, k)), "ground_truth shape")
        td, ti = truth(i)
        s = r.plan.strategy
        by_plan.setdefault(s, []).append(r.result.elapsed)
        if s in ("pre", "ipre"):
            check(same_up_to_ties(qs[i], r.result.ids, r.result.dists, ti, td),
                  f"query {i} ({s}): exact plan {r.result.ids} {r.result.dists} differs "
                  f"from ground truth {ti} {td}")
        else:
            recalls.append(recall_at_k(r.result.ids, ti))
    print(f"[main] served {n_serve} queries: plans "
          + ", ".join(f"{s} {len(v)}" for s, v in sorted(by_plan.items())), flush=True)

    # every executor directly, whatever the planner chose
    direct = {}
    mask_s, pre_s = [], []
    for name, ex in (("pre", eng.pre_exec), ("ipre", eng.ipre_exec), ("post", eng.post_exec)):
        rec = []
        for i in range(8):
            if name == "post":
                res = ex.search(qs[i:i + 1], ps[i], k, est_selectivity=served[i].plan.est)
            else:
                res = ex.search(qs[i:i + 1], ps[i], k)
            td, ti = truth(i)
            if name == "post":
                rec.append(recall_at_k(res.ids, ti))
            else:
                check(same_up_to_ties(qs[i], res.ids, res.dists, ti, td),
                      f"{name}_exec query {i}: {res.ids} {res.dists} differs from "
                      f"ground truth {ti} {td}")
            if name == "pre":
                t1 = time.perf_counter()
                ps[i].eval(eng.cat, eng.num)
                mask_s.append(time.perf_counter() - t1)
                pre_s.append(res.elapsed)
        direct[name] = rec
    recalls += direct["post"]
    check(launches["masked_l2_topk"] > 0, "the main path launched masked_l2_topk no time")
    post_recall = float(np.mean(recalls)) if recalls else float("nan")
    mask_share = float(np.median(mask_s) / np.median(pre_s))
    print(f"[main] post recall@10 {post_recall:.4f} over {len(recalls)} queries; "
          f"exact plans equal ground truth up to ties; batch ids equal per-query ids", flush=True)
    for s, v in sorted(by_plan.items()):
        v = np.asarray(v) * 1e3
        print(f"[main] {s}: {len(v)} queries, p50 {np.percentile(v, 50):.3f} ms, "
              f"p99 {np.percentile(v, 99):.3f} ms")
    print(f"[main] batch_query (batch {batch}): {n_serve / batch_s:.1f} QPS")
    print(f"[main] host columnar mask: median {np.median(mask_s) * 1e3:.3f} ms of a pre "
          f"query's median {np.median(pre_s) * 1e3:.3f} ms (share {mask_share:.3f})")
    print(f"[main] kernel launches {launches}; dispatches {dispatch}", flush=True)
    shared = shared_predicate_batch(eng, q_all, preds, k)
    where_time_goes(eng, qs, ps, served, k)
    return {"launches": launches, "post_recall": post_recall, "engine": eng, "ds": ds,
            "preds": ps, "qs": qs, "train": (qt, pt), "served": served, "shared": shared,
            "pre_ms": float(np.median(pre_s) * 1e3)}


def shared_predicate_batch(eng, q_all, preds, k: int, n: int = 256) -> dict:
    """Many queries under one predicate (a tenant or category filter over a
    batch) through the exact executors: 256 of phase 4's query vectors in
    one search() call, under the gen_queries predicate that passes the most
    rows (over 25 %: the full-corpus branch) and one that passes about 10 %
    (the gathered branch).  Each row must equal that query's B=1 search()
    bitwise, and ground truth up to ties."""
    import numpy as np
    import torch

    from repro_torch.index.flat import l2_topk
    from repro_torch.kernels import ops

    frac = np.array([p.eval(eng.cat, eng.num).mean() for p in preds])
    full, below = int(np.argmax(frac)), np.flatnonzero(frac < eng.pre_exec.FULL_SCAN_FRAC)
    gathered = int(below[np.argmin(np.abs(frac[below] - 0.1))])
    check(frac[full] > eng.pre_exec.FULL_SCAN_FRAC,
          f"no gen_queries predicate passes more than 25 % of the rows ({frac.max():.3f})")
    qb = np.ascontiguousarray(q_all[:n])
    vd = eng.vectors_dev
    out = {}
    for branch, i in (("full", full), ("gathered", gathered)):
        mask = preds[i].eval(eng.cat, eng.num)
        td, ti = l2_topk(torch.as_tensor(qb, device=vd.device), vd, k,
                         torch.as_tensor(mask, device=vd.device))
        td, ti = td.cpu().numpy(), ti.cpu().numpy()
        for name, ex in (("pre", eng.pre_exec), ("ipre", eng.ipre_exec)):
            ex.search(qb, preds[i], k)                      # warm: caches, allocator
            ops.reset_kernel_launches()
            t0 = time.perf_counter()
            res = ex.search(qb, preds[i], k)
            batch_s = time.perf_counter() - t0
            l_batch = ops.kernel_launches()["masked_l2_topk"]
            t0 = time.perf_counter()
            solo = [ex.search(qb[j:j + 1], preds[i], k) for j in range(n)]
            solo_s = time.perf_counter() - t0
            l_solo = ops.kernel_launches()["masked_l2_topk"] - l_batch
            check(l_batch == 1 and l_solo == n,
                  f"{name}_exec {branch}: {l_batch} launches for the batch, {l_solo} for {n} queries")
            for j in range(n):
                check(np.array_equal(res.ids[j], solo[j].ids[0]),
                      f"{name}_exec {branch} batch row {j}: {res.ids[j]} differs from the same "
                      f"query alone {solo[j].ids[0]}")
                check(same_up_to_ties(qb[j], res.ids[j:j + 1], res.dists[j:j + 1],
                                      ti[j:j + 1], td[j:j + 1]),
                      f"{name}_exec {branch} batch row {j} differs from ground truth")
            out[(name, branch)] = dict(batch_ms=batch_s * 1e3 / n, solo_ms=solo_s * 1e3 / n,
                                       pass_frac=float(frac[i]), launches=l_batch)
            print(f"[main] shared predicate ({branch} branch: gen_queries[{i}] passes "
                  f"{frac[i]:.4f}), {name}_exec, {n} queries: batched {batch_s * 1e3 / n:.4f} ms "
                  f"per query ({l_batch} masked_l2_topk launch), one at a time "
                  f"{solo_s * 1e3 / n:.4f} ms per query ({l_solo} launches); speedup "
                  f"{solo_s / batch_s:.1f}x; every row equals its query alone (ids, bitwise) and "
                  f"ground truth up to ties", flush=True)
    return out


def real_row_independence(mp: dict, k: int = 10, n: int = 256, batch: int = 64) -> dict:
    """Phase 3e, on real data: n of phase 4's queries (its 200 served ones,
    then its training ones) on the arxiv corpus, each under its own
    predicate's mask and on the rows the pre executor hands the kernel (the
    full corpus under the mask above FULL_SCAN_FRAC passing, else the
    gathered passing rows): the row alone (B=1, the streaming path) equals
    the same row inside a batch of 64 under that mask (the tiled path),
    ids and distances bitwise.  Beside it, not gated: the clean engine's
    ground_truth (l2_topk, a GEMM and torch.topk) against the kernel's row,
    the ranks where the two order rows differently and every such row's
    distance under both and in fp64 (the two must agree up to ties)."""
    import numpy as np
    import torch

    from repro_torch.index.flat import l2_topk
    from repro_torch.kernels import masked_l2
    from repro_torch.kernels.ops import fused_masked_topk

    t0 = time.perf_counter()
    eng = mp["engine"]
    qt, pt = mp["train"]
    qs = np.concatenate([mp["qs"], qt])[:n]
    ps = (list(mp["preds"]) + list(pt))[:n]
    vd = eng.vectors_dev
    n_sms = torch.cuda.get_device_properties(vd.device).multi_processor_count
    q_dev = torch.as_tensor(qs, device=vd.device)
    paths, n_swapped, reports = {}, 0, []
    for i in range(len(qs)):
        mask = ps[i].eval(eng.cat, eng.num)
        m = torch.as_tensor(mask, device=vd.device)
        n_pass = int(mask.sum())
        if n_pass > eng.pre_exec.FULL_SCAN_FRAC * len(mask):
            rows, sub, sub_mask = None, vd, m
        else:
            rows = torch.nonzero(m).squeeze(1)
            sub, sub_mask = vd[rows], torch.ones(n_pass, dtype=torch.bool, device=vd.device)
        pos = i % batch
        others = [j for j in range(len(qs)) if j != i][:batch - 1]
        qb = torch.cat([q_dev[others[:pos]], q_dev[i:i + 1], q_dev[others[pos:]]])
        kk = min(k, n_pass)
        bd, bi = fused_masked_topk(qb, sub, sub_mask, kk)
        sd, si = fused_masked_topk(q_dev[i:i + 1], sub, sub_mask, kk)
        plan = (masked_l2.plan(1, sub.shape[0], vd.shape[1], kk, n_sms).path,
                masked_l2.plan(batch, sub.shape[0], vd.shape[1], kk, n_sms).path)
        paths[plan] = paths.get(plan, 0) + 1
        check(torch.equal(sd[0], bd[pos]) and torch.equal(si[0], bi[pos]),
              f"query {i} ({n_pass} rows pass): alone ({plan[0]}) {si[0].tolist()} "
              f"{sd[0].tolist()} differs from row {pos} of a batch of {batch} ({plan[1]}) "
              f"{bi[pos].tolist()} {bd[pos].tolist()}")
        ids = si if rows is None else torch.where(si >= 0, rows[si.clamp_min(0).long()], -1)
        kd, ki = sd.cpu().numpy(), ids.cpu().numpy().astype(np.int32)
        td, ti = (t.cpu().numpy() for t in l2_topk(q_dev[i:i + 1], vd, kk, m))
        check(same_up_to_ties(qs[i], ki, kd, ti, td),
              f"query {i}: the kernel's row {ki} {kd} and l2_topk's {ti} {td} differ beyond ties")
        if not np.array_equal(ki, ti):
            n_swapped += 1
            if len(reports) < 8:
                reports.append(f"query {i} ({n_pass} rows pass): " + rank_diff(
                    eng, qs[i], {"kernel": (kd, ki), "l2_topk": (td, ti)}))
    secs = time.perf_counter() - t0
    print(f"[kernel-real] {len(qs)} of phase 4's queries under their own masks on arxiv "
          f"{tuple(vd.shape)}: the row alone equals its row in a batch of {batch}, ids and "
          f"distances bitwise (B=1 path, B={batch} path: "
          + ", ".join(f"{a}/{b} {c}" for (a, b), c in sorted(paths.items()))
          + f"); l2_topk (the clean engine's ground_truth) orders the top-{k} otherwise than "
          f"the kernel for {n_swapped} of {len(qs)} queries, all within ties; {secs:.1f} s",
          flush=True)
    for line in reports:
        print(f"[kernel-real] {line}", flush=True)
    return {"paths": paths, "l2_topk_order_differs": n_swapped, "seconds": secs}


def where_time_goes(eng, qs, ps, served, k: int, n: int = 40) -> None:
    """Device busy time against host wall time for each plan's executor,
    over n warm queries under torch.profiler, and the top device kernels."""
    profile_runs({
        "pre": lambda i: eng.pre_exec.search(qs[i:i + 1], ps[i], k),
        "ipre": lambda i: eng.ipre_exec.search(qs[i:i + 1], ps[i], k),
        "post": lambda i: eng.post_exec.search(qs[i:i + 1], ps[i], k,
                                               est_selectivity=served[i].plan.est),
    }, n)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_busy(dev, fn):
    """(fn(), host wall s, device busy s, device-side profiler rows) of one
    call under torch.profiler; busy is None off the card or when the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0, None, []
    _sync(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        _sync(dev)
    wall = time.perf_counter() - t0
    # device-side events only: a CPU op's row repeats its kernels' time
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ka) / 1e6
    return out, wall, (busy if busy > 0 else None), ka


def profile_runs(runs: dict, n: int, tag: str = "time") -> None:
    """For each ``runs[name](i)``, i < n: device busy against host wall per
    call under torch.profiler (after a warm pass), the idle share, and the
    top device kernels."""
    import torch

    for name, run in runs.items():
        for i in range(n):          # warm: predicate cache, allocator
            run(i)
        _, wall, busy, ka = _device_busy(torch.device("cuda"),
                                         lambda: [run(i) for i in range(n)])
        if busy is None:
            print(f"[{tag}] {name}: device time not measured (profiler saw none)")
            continue
        wall, busy = wall * 1e3, busy * 1e3
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:4]
        print(f"[{tag}] {name}: {n} queries, wall {wall / n:.3f} ms/query, device busy "
              f"{busy / n:.3f} ms/query, device idle share {1 - busy / wall:.3f}; top: "
              + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / n:.3f} ms"
                          for e in top), flush=True)


# ----------------------------------------------------------------------
# phase 4b: DNF unions on the phase-4 engine
# ----------------------------------------------------------------------
def make_unions(ps, n: int = 64, pool: int = 24, seed: int = 4):
    """n Ors of 2-3 of phase 4's served predicates, drawn from the first
    `pool` of them so terms recur across unions; union 1 is union 0
    permuted and union 2 repeats a term."""
    import numpy as np

    from repro_torch.core import Or

    rng = np.random.default_rng(seed)
    terms = [[int(t) for t in rng.choice(pool, size=int(rng.integers(2, 4)), replace=False)]
             for _ in range(n)]
    terms[1] = terms[0][::-1]
    terms[2] = terms[2][:2] + terms[2][:1]
    return [Or(tuple(ps[t] for t in ts)) for ts in terms]


def exact_plan(plan) -> bool:
    from repro_torch.core import INDEXED_PRE, PRE_FILTER

    return all(c.decision in (PRE_FILTER, INDEXED_PRE) for c in plan.clauses)


class TruthMemo:
    """Exact top-k with distances over a clean engine's device corpus
    (``l2_topk``, independent of the serving path), one per (query, pred)."""

    def __init__(self, eng, k: int):
        self.eng, self.k, self.memo = eng, k, {}

    def __call__(self, q, pred):
        import numpy as np
        import torch

        from repro_torch.index.flat import l2_topk

        key = (np.asarray(q, np.float32).tobytes(), id(pred))
        if key not in self.memo:
            vd = self.eng.vectors_dev
            m = torch.as_tensor(pred.eval(self.eng.cat, self.eng.num), device=vd.device)
            d, i = l2_topk(torch.as_tensor(np.atleast_2d(q), device=vd.device), vd, self.k, m)
            self.memo[key] = (d.cpu().numpy(), i.cpu().numpy())
        return self.memo[key]


def check_rows(eng, qs, preds, served, batched, k: int, tag: str, truth_of=None) -> dict:
    """Every id passes its predicate, once; batch_query rows equal query
    rows; rows that `truth_of` selects equal ground truth up to ties.
    Returns per-row recall@10 against ground truth."""
    import numpy as np

    from repro_torch.core import recall_at_k

    truth = TruthMemo(eng, k)
    recalls = []
    for i, (r, br) in enumerate(zip(served, batched)):
        mask = preds[i].eval(eng.cat, eng.num)
        ids = r.result.ids[0][r.result.ids[0] >= 0]
        check(r.result.ids.shape == (1, k) and bool(mask[ids].all()),
              f"{tag} {i}: an id fails its predicate {preds[i]}")
        check(len(set(ids.tolist())) == ids.size, f"{tag} {i}: an id came back twice: {ids}")
        check(np.array_equal(r.result.ids, br.result.ids),
              f"{tag} {i}: batch_query ids {br.result.ids} differ from query ids {r.result.ids}")
        td, ti = truth(qs[i], preds[i])
        check(np.array_equal(eng.ground_truth(qs[i], preds[i], k).shape, (1, k)), "ground_truth shape")
        if truth_of is not None and truth_of(r):
            check(same_up_to_ties(qs[i], r.result.ids, r.result.dists, ti, td),
                  f"{tag} {i} ({r.plan.strategy}): {r.result.ids} {r.result.dists} differs from "
                  f"ground truth {ti} {td}")
        recalls.append(recall_at_k(r.result.ids, ti))
    return {"recall": recalls}


def dnf_phase(mp: dict, k: int = 10, batch: int = 64) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import STRATEGY_NAMES
    from repro_torch.kernels import ops

    eng, qs, ps, served4 = mp["engine"], mp["qs"], mp["preds"], mp["served"]
    unions = make_unions(ps)
    n = len(unions)
    uq = np.ascontiguousarray(qs[:n])
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    served = [eng.query(uq[j], unions[j], k) for j in range(n)]
    l_query = ops.kernel_launches()["masked_l2_topk"]
    # unions interleaved with phase 4's conjunctions, in batches of 64
    mixed_q = np.stack([x for j in range(n) for x in (uq[j], qs[n + j])])
    mixed_p = [x for j in range(n) for x in (unions[j], ps[n + j])]
    batched = []
    for s in range(0, len(mixed_p), batch):
        batched += eng.batch_query(mixed_q[s:s + batch], mixed_p[s:s + batch], k)
    launches = ops.kernel_launches()
    check(launches["masked_l2_topk"] > 0, "the DNF path launched masked_l2_topk no time")
    check(served[1].plan is served[0].plan and served[0].plan.is_dnf,
          "the permuted Or did not hit union 0's plan-cache entry")
    check(served[2].plan.n_clauses == 2, "the Or with a repeated term did not collapse it")
    for j in range(n):
        conj = batched[2 * j + 1]
        check(np.array_equal(conj.result.ids, served4[n + j].result.ids),
              f"conjunction {n + j} in a mixed batch differs from its phase-4 query")
    rows = check_rows(eng, uq, unions, served, batched[0::2], k, "union", truth_of=lambda r:
                      exact_plan(r.plan))
    # all-exact unions against ONE fused masked top-k over the union mask
    # (comparison launches, after the counts were read)
    vd = eng.vectors_dev
    n_exact = n_bitwise = 0
    for j, r in enumerate(served):
        if not exact_plan(r.plan):
            continue
        n_exact += 1
        m = torch.as_tensor(unions[j].eval(eng.cat, eng.num), device=vd.device)
        d, i = ops.fused_masked_topk(torch.as_tensor(uq[j:j + 1], device=vd.device), vd, m, k)
        n_bitwise += int(np.array_equal(i.cpu().numpy(), r.result.ids)
                         and np.array_equal(d.cpu().numpy(), r.result.dists))
    clause_mix: dict = {}
    by_size: dict = {}
    for r in served:
        for c in r.plan.clauses:
            key = STRATEGY_NAMES[c.decision]
            clause_mix[key] = clause_mix.get(key, 0) + 1
        by_size.setdefault(r.plan.n_clauses, []).append(r.result.elapsed * 1e3)
    approx = [x for x, r in zip(rows["recall"], served) if not exact_plan(r.plan)]
    print(f"[dnf] {n} unions of 2-3 phase-4 predicates: clause plans "
          + ", ".join(f"{s} {c}" for s, c in sorted(clause_mix.items()))
          + f"; {n_exact} all-exact unions equal ground truth up to ties, {n_bitwise} of them equal "
          f"one fused_masked_topk over the union mask bitwise; unions with a post clause: "
          f"{len(approx)}, recall@10 {np.mean(approx) if approx else float('nan'):.4f}", flush=True)
    for size, v in sorted(by_size.items()):
        print(f"[dnf] {size} clause(s): {len(v)} unions, query() p50 {np.percentile(v, 50):.3f} ms, "
              f"p99 {np.percentile(v, 99):.3f} ms", flush=True)
    print(f"[dnf] masked_l2_topk launches {l_query} over {n} query() calls "
          f"({l_query / n:.2f} per union), {launches['masked_l2_topk'] - l_query} over "
          f"{-(-len(mixed_p) // batch)} mixed batch_query() calls; every id passes its union once; "
          f"batch rows equal query rows; the permuted Or hit the plan cache", flush=True)
    return {"launches": launches, "unions": unions, "n_exact": n_exact, "n_bitwise": n_bitwise,
            "clause_mix": clause_mix}


# ----------------------------------------------------------------------
# phase 4c: a routed engine (flat, ivf, ivfpq, acorn) at full size
# ----------------------------------------------------------------------
BACKENDS = ("flat", "ivf", "ivfpq", "acorn")
# phase 4c fits on the first 8 of phase 4's training queries and measures
# each class's recall on 16 fixed queries: both race or run ACORN's host beam
# search, 1.2-13 s a query at 2.14M rows on an H100 and slower still on a
# slow host.  At 32 and 32 the fit took 357 s and the script 1,034 s of its
# 1,200 s; at 16 and 32 a run with the LM phases of gemma2 and olmoe passed
# 1,320 s, 4c's fit 197 s and its ACORN recall queries ~450 s (PERF.md
# section 4)
ROUTED_TRAIN = 8
ROUTED_FIXED = 16
# phase 6 serves qwen3-14b at full width but 20 of its 40 layers, so that the
# script keeps its headroom (PERF.md section 4)
QWEN_LAYERS = 20


def threshold_head(sel_cut: float) -> dict:
    """Planner state (the reference's format) whose plan head says post iff
    the estimated selectivity exceeds ``sel_cut``."""
    import numpy as np

    from repro_torch.core import PlannerFeatures

    f = PlannerFeatures.N_FEATURES - 1
    p = {"w1": np.zeros((f, 64), np.float32), "b1": np.zeros(64, np.float32),
         "w2": np.zeros((64, 32), np.float32), "b2": np.zeros(32, np.float32),
         "w3": np.zeros((32, 2), np.float32), "b3": np.zeros(2, np.float32)}
    p["w1"][PlannerFeatures.SEL_COL, 0] = 1.0
    p["w2"][0, 0] = 1.0
    p["w3"][0, 1] = 1.0
    p["b3"][0] = 1.0
    mu, sigma = np.zeros(f, np.float32), np.ones(f, np.float32)
    mu[PlannerFeatures.SEL_COL], sigma[PlannerFeatures.SEL_COL] = sel_cut - 0.01, 0.01
    return {"params": p, "mu": mu, "sigma": sigma,
            "meta": np.asarray([PlannerFeatures.N_FEATURES, 0], np.int32)}


def spanning_routes(eng, qs, ps, k: int, per_class: int = 2) -> dict:
    """Serve through a routing head that spans every class: a plan head
    that sends every row post, and a routing head fitted on the served
    predicates' features with labels cycled over the classes in order of
    estimated selectivity (as the CPU tests' routed engine).  Then up to
    ``per_class`` rows routed to each class go through query() and one
    batch_query(), so the routed groups of every backend run on the card."""
    import numpy as np

    from repro_torch.kernels import ops

    names = eng.backend_set.class_names()
    eng.planner.load_state(threshold_head(-1.0))
    ests = [eng.estimator.estimate(p) for p in ps]
    feats = np.stack([eng.feat.vector(p, se.sel, k, se.is_exact) for p, se in zip(ps, ests)])
    order = np.argsort([se.sel for se in ests], kind="stable")
    labels = np.empty(len(ps), np.int64)
    labels[order] = np.arange(len(ps)) * len(names) // len(ps)
    eng.planner.fit_routing(feats, labels, names)
    plans = eng.make_plan_batch(ps, k)[0]
    rows: dict = {}
    for i, plan in enumerate(plans):
        rows.setdefault(plan.clauses[0].route, []).append(i)
    pick = sorted(i for r, v in rows.items() if r >= 0 for i in v[:per_class])
    sq = np.ascontiguousarray(qs[pick])
    sp = [ps[i] for i in pick]
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    served = [eng.query(sq[j], sp[j], k) for j in range(len(sp))]
    batched = eng.batch_query(sq, sp, k)
    launches = ops.kernel_launches()
    dispatches = ops.dispatch_counts()
    check_rows(eng, sq, sp, served, batched, k, "spanning", truth_of=lambda r: (
        r.result.backend, r.result.knob) == ("flat", "exact"))
    got = {r.result.backend for r in served}
    check(got == set(eng.backend_set.backends),
          f"the spanning routing head served backends {sorted(got)} only")
    for nm in eng.backend_set.backends:
        check(dispatches.get(f"backend_{nm}", 0) > 0, f"no routed group ran on backend {nm}")
    mix: dict = {}
    for r in served:
        key = f"{r.result.backend}:{r.result.knob}"
        mix[key] = mix.get(key, 0) + 1
    print(f"[routed] spanning routing head: {len(sp)} rows routed "
          + ", ".join(f"{key} {c}" for key, c in sorted(mix.items()))
          + f" ({len([r for r in rows if r >= 0])} of {len(names)} classes routed over "
          f"{len(ps)} predicates) through query() and one batch_query(): every id passes its "
          f"predicate once, flat:exact rows equal ground truth up to ties, batch rows equal "
          f"query rows; kernel launches {launches}; dispatches {dispatches}", flush=True)
    return {"launches": launches, "mix": mix, "qs": sq, "preds": sp}


def tiny_flat_check(k: int = 10) -> None:
    """Below TINY_N rows on the card the flat backend runs the kernel,
    equal to the reference's numpy scan up to exact ties (comparison
    launches, outside every counted path)."""
    import numpy as np

    from repro_torch.index.registry import TINY_N, _exact_masked, make_backend
    from repro_torch.kernels import ops

    rng = np.random.default_rng(5)
    for n in (1, 9, TINY_N - 1):
        x = rng.normal(0, 1, (n, 384)).astype(np.float32)
        q = rng.normal(0, 1, (4, 384)).astype(np.float32)
        mask = rng.random(n) < 0.7
        before = ops.kernel_launches()["masked_l2_topk"]
        d, i = make_backend("flat", x, device="cuda").search_masked(q, mask, k)
        check(ops.kernel_launches()["masked_l2_topk"] == before + 1,
              f"the flat backend at {n} rows did not launch masked_l2_topk")
        want_d, want_i = _exact_masked(x, q, mask, k)
        for j in range(len(q)):
            check(same_up_to_ties(q[j], i[j:j + 1], d[j:j + 1], want_i[j:j + 1], want_d[j:j + 1]),
                  f"flat backend at {n} rows, query {j}: {i[j]} {d[j]} differ from the numpy "
                  f"scan {want_i[j]} {want_d[j]}")
    print(f"[routed] flat backend below TINY_N ({TINY_N}) rows on the card: the kernel equals "
          f"the numpy scan up to ties at 1, 9 and {TINY_N - 1} rows", flush=True)


def routed_phase(mp: dict, unions: list, k: int = 10, n_train: int = ROUTED_TRAIN,
                 n_unions: int = 32, n_fixed: int = ROUTED_FIXED, batch: int = 64) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import EngineConfig, FilteredANNEngine, recall_at_k
    from repro_torch.index.flat import l2_topk
    from repro_torch.kernels import ops

    ds, qs, ps = mp["ds"], mp["qs"], mp["preds"]
    qt, pt = mp["train"]
    tiny_flat_check(k)
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    t0 = time.perf_counter()
    eng = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                            EngineConfig(device="cuda", backends=BACKENDS)).build()
    torch.cuda.synchronize()
    bs = eng.backend_set
    print(f"[routed] build {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k_} {v:.3f} s" for k_, v in eng.build_time_.items())
          + "; memory_bytes " + ", ".join(f"{nm} {b / 1e9:.3f} GB" for nm, b in bs.memory_bytes().items())
          + f" (ivfpq re-rank vectors {bs.backends['ivfpq'].rerank_bytes / 1e9:.3f} GB apart; "
          f"ivf shares the engine's IVF: {bs.backends['ivf'].index is eng.ivf}); "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on the card", flush=True)
    eng.fit(qt[:n_train], pt[:n_train], k=k)
    names = bs.class_names()
    rl = np.bincount(eng.route_labels_, minlength=len(names))
    pl = np.bincount(eng.labels_, minlength=2)
    print(f"[routed] fit {eng.build_time_['fit']:.2f} s on {n_train} queries: labels pre {pl[0]} / "
          f"post {pl[1]}; route labels " + ", ".join(f"{nm} {c}" for nm, c in zip(names, rl)),
          flush=True)
    uq = np.ascontiguousarray(qs[:n_unions])
    all_q = np.concatenate([qs, uq])
    all_p = list(ps) + list(unions[:n_unions])
    served = [eng.query(all_q[i], all_p[i], k) for i in range(len(all_p))]
    batched = []
    for s in range(0, len(all_p), batch):
        batched += eng.batch_query(all_q[s:s + batch], all_p[s:s + batch], k)
    launches = ops.kernel_launches()
    check(launches["masked_l2_topk"] > 0, "the routed engine launched masked_l2_topk no time")

    def flat_exact(r):
        return r.plan.is_dnf and exact_plan(r.plan) or (r.result.backend, r.result.knob) == ("flat", "exact")

    check_rows(eng, all_q, all_p, served, batched, k, "routed", truth_of=flat_exact)
    mix: dict = {}
    for r in served:
        for c in r.plan.clauses:
            key = f"{('pre', 'post', 'ipre')[c.decision]}/{c.backend}:{c.knob}"
            mix.setdefault(key, []).append(r.result.elapsed * 1e3 if not r.plan.is_dnf else None)
    print(f"[routed] served {len(ps)} queries + {n_unions} unions: every id passes its predicate "
          f"once; flat:exact rows and all-exact unions equal ground truth up to ties; batch rows "
          f"equal query rows; clause mix (decision/backend:knob) "
          + ", ".join(f"{key} {len(v)}" for key, v in sorted(mix.items())), flush=True)
    for key, v in sorted(mix.items()):
        v = np.asarray([x for x in v if x is not None])
        if v.size:
            print(f"[routed] {key}: {v.size} conjunctions, query() p50 {np.percentile(v, 50):.3f} ms, "
                  f"p99 {np.percentile(v, 99):.3f} ms", flush=True)
    dnf_ms = [r.result.elapsed * 1e3 for r in served if r.plan.is_dnf]
    print(f"[routed] unions: query() p50 {np.percentile(dnf_ms, 50):.3f} ms, p99 "
          f"{np.percentile(dnf_ms, 99):.3f} ms", flush=True)
    # every class directly on n_fixed fixed queries, against ground truth
    vd = eng.vectors_dev
    masks = [ps[i].eval(eng.cat, eng.num) for i in range(n_fixed)]
    truth = [l2_topk(torch.as_tensor(qs[i:i + 1], device=vd.device), vd, k,
                     torch.as_tensor(masks[i], device=vd.device))[1].cpu().numpy()
             for i in range(n_fixed)]
    recalls, host_ids = {}, {}
    for ci, nm in enumerate(names):
        rec, ms, out = [], [], []
        for i in range(n_fixed):
            t1 = time.perf_counter()
            _, ids = bs.search_class(ci, qs[i:i + 1], masks[i], k)
            ms.append((time.perf_counter() - t1) * 1e3)
            valid = ids[ids >= 0]
            check(bool(masks[i][valid].all()), f"{nm} query {i}: an id fails its predicate")
            check(len(set(valid.tolist())) == valid.size, f"{nm} query {i}: an id came back twice")
            rec.append(recall_at_k(ids, truth[i]))
            out.append(ids)
        recalls[nm], host_ids[nm] = float(np.mean(rec)), (out, ms)
        floor = bs.recall_floor(ci)
        print(f"[routed] {nm}: every id passes its mask once; recall@10 {recalls[nm]:.4f} over "
              f"{n_fixed} queries (floor {floor}"
              f"{'' if recalls[nm] >= floor else ', BELOW'}), search_class p50 "
              f"{np.median(ms):.3f} ms, mean {np.mean(ms):.3f} ms", flush=True)
    # ACORN's device search against its host search (acorn:fast is ef 64)
    acorn = bs.backends["acorn"].index
    hi, host_ms = host_ids["acorn:fast"]
    agree, rt, t_torch = [], [], 0.0
    for i in range(n_fixed):
        t1 = time.perf_counter()
        _, ti_ = acorn.search_torch(qs[i:i + 1], k, ef=64, mask=masks[i])
        ti_ = ti_.cpu().numpy()
        t_torch += time.perf_counter() - t1
        agree.append(recall_at_k(ti_, hi[i]))
        rt.append(recall_at_k(ti_, truth[i]))
    print(f"[routed] acorn search_torch (ef 64) against search: recall of search's ids "
          f"{np.mean(agree):.4f}; against ground truth {np.mean(rt):.4f} vs search "
          f"{recalls['acorn:fast']:.4f}; {t_torch * 1e3 / n_fixed:.1f} vs {np.mean(host_ms):.1f} ms "
          f"per query (mean)", flush=True)
    print(f"[routed] kernel launches {launches}; dispatches {ops.dispatch_counts()}", flush=True)
    span = spanning_routes(eng, qs, ps, k)
    live = routed_live(eng, span["qs"], span["preds"], k)
    total = {nm: launches[nm] + span["launches"][nm] + live["launches"][nm] for nm in launches}
    return {"launches": total, "recalls": recalls, "engine": eng, "live_launches": live["launches"]}


# ----------------------------------------------------------------------
# phase 4d: the live corpus and sharded serving at full size
# ----------------------------------------------------------------------
TOMBSTONE_FRACS = (0.02, 0.05, 0.10)   # benchmarks/mutation_bench.py's churn mix
SEG_FRAC = 0.02


def live_truth(eng, q, pred, k: int):
    """Exact top-k over the LIVE rows, independent of the serving path:
    ``l2_topk`` over the base rows (tombstones masked out) and over the
    segment's device rows, merged base part first, with distances."""
    import numpy as np
    import torch

    from repro_torch.dist import merge_topk
    from repro_torch.index.flat import l2_topk

    live, vd = eng.live, eng.vectors_dev
    alive = live.alive_mask()
    qt = torch.as_tensor(np.atleast_2d(q), device=vd.device)
    m = torch.as_tensor(pred.eval(eng.cat, eng.num) & alive[:live.base_n], device=vd.device)
    d, i = (t.cpu().numpy() for t in l2_topk(qt, vd, k, m))
    sm = pred.eval(live.seg_cat(), live.seg_num()) & alive[live.base_n:]
    if sm.any():
        sd, si = (t.cpu().numpy() for t in l2_topk(qt, live.seg_vectors_dev(), min(k, live.seg_n),
                                                    torch.as_tensor(sm, device=vd.device)))
        si = np.where(si >= 0, si + live.base_n, -1).astype(np.int32)
        d, i = merge_topk(np.stack([d, np.pad(sd, ((0, 0), (0, k - sd.shape[1])),
                                               constant_values=np.inf)]),
                          np.stack([i, np.pad(si, ((0, 0), (0, k - si.shape[1])),
                                              constant_values=-1)]), k)
    return d, i


def kernel_truth(eng, q, pred, k: int):
    """(dists, ids) (1, k) of the pre-filter path at B=1, the arithmetic
    exact plans serve with (the masked_l2_topk kernel): on a mutated
    corpus the live ground_truth's own path, on a clean one the pre
    executor (a clean engine's ground_truth is l2_topk, a GEMM and
    torch.topk, which rounds other than the kernel)."""
    import numpy as np

    from repro_torch.core.engine import PRE_FILTER, _execute_grouped

    q = np.atleast_2d(np.asarray(q, np.float32))
    if not eng.live.dirty:
        res = eng.pre_exec.search(q, pred, k)
        return res.dists, res.ids
    d, ids, _ = _execute_grouped(eng.pre_exec, None, eng.post_exec, q, [pred], k,
                                 np.full(1, PRE_FILTER), np.zeros(1), live=eng.live)
    return d, ids


def row_vectors(eng, ids):
    """Host vectors of handles ``ids`` (base rows, then the live segment's)."""
    import numpy as np

    base_n = eng.live.base_n
    seg = eng.live.seg_vectors() if eng.live.seg_n else np.zeros((0, eng.vectors.shape[1]))
    return np.stack([eng.vectors[i] if i < base_n else seg[i - base_n] for i in ids])


def rank_diff(eng, q, paths: dict) -> str:
    """The ranks where two or more (dists, ids) answers for query q order
    the rows differently, with each row's distance under every path (nan
    where a path did not return it) and in fp64 from the host vectors."""
    import numpy as np

    q = np.asarray(q, np.float32).reshape(-1)
    ids = {name: np.asarray(i).reshape(-1) for name, (_, i) in paths.items()}
    dists = {name: np.asarray(d).reshape(-1) for name, (d, _) in paths.items()}
    ref = next(iter(ids.values()))
    ranks = [r for r in range(ref.size) if len({int(v[r]) for v in ids.values()}) > 1]
    rows = sorted({int(v[r]) for v in ids.values() for r in ranks} - {-1})
    if not rows:
        return "no rank differs"
    exact = ((row_vectors(eng, rows).astype(np.float64) - q.astype(np.float64)) ** 2).sum(1)
    out = []
    for j, row in enumerate(rows):
        per = []
        for name in paths:
            hit = np.flatnonzero(ids[name] == row)
            per.append(f"{name} {float(dists[name][hit[0]])!r} (rank {hit[0]})" if hit.size
                       else f"{name} -")
        out.append(f"row {row}: " + ", ".join(per) + f", fp64 {float(exact[j])!r}")
    return f"ranks {ranks} differ; " + "; ".join(out)


def check_live_row(eng, q, pred, r, k: int, tag: str, exact: bool = False) -> None:
    """One row served over a live corpus: no tombstoned id, every id
    passes its predicate once; an ``exact`` row's ids equal, bitwise,
    those of the pre-filter path at B=1 (``kernel_truth``: the live
    ground_truth's own path on a mutated corpus), and the row equals the
    independent live truth (l2_topk) up to ties.  A failure prints each differing row's distance under each
    path and in fp64."""
    import numpy as np

    live = eng.live
    ids = r.result.ids[0][r.result.ids[0] >= 0]
    check(not live.is_deleted(ids).any(), f"{tag}: a tombstoned id came back: {ids}")
    c, m = live.row_attrs(ids)
    check(r.result.ids.shape == (1, k) and bool(pred.eval(c, m).all()),
          f"{tag}: an id fails its predicate {pred}")
    check(len(set(ids.tolist())) == ids.size, f"{tag}: an id came back twice: {ids}")
    if not exact:
        return
    gd, gt = kernel_truth(eng, q, pred, k)
    td, ti = live_truth(eng, q, pred, k)
    paths = {"served": (r.result.dists, r.result.ids), "B=1 pre path": (gd, gt),
             "l2_topk": (td, ti)}
    check(np.array_equal(r.result.ids, gt),
          f"{tag} ({r.plan.strategy}, corpus {'dirty' if live.dirty else 'clean'}): "
          f"{r.result.ids} differs from the B=1 pre path {gt}: " + rank_diff(eng, q, paths))
    check(same_up_to_ties(np.asarray(q, np.float32), r.result.ids, r.result.dists, ti, td),
          f"{tag} ({r.plan.strategy}): {r.result.ids} {r.result.dists} differs from the live "
          f"truth {ti} {td}: " + rank_diff(eng, q, paths))


def check_live_rows(eng, qs, preds, served, batched, k: int, tag: str, exact_of=None) -> dict:
    """Rows served over a mutated corpus (``check_live_row``, exact where
    ``exact_of`` says), and batch rows equal query rows bitwise.  With
    ``exact_of``, returns recall@10 of the other rows against the live
    truth."""
    import numpy as np

    from repro_torch.core import recall_at_k

    recalls, n_exact = [], 0
    for i, (r, br) in enumerate(zip(served, batched)):
        check(np.array_equal(r.result.ids, br.result.ids),
              f"{tag} {i}: batch_query ids {br.result.ids} differ from query ids {r.result.ids}")
        exact = exact_of is not None and bool(exact_of(r))
        check_live_row(eng, qs[i], preds[i], r, k, f"{tag} {i}", exact)
        n_exact += exact
        if exact_of is not None and not exact:
            recalls.append(recall_at_k(r.result.ids, live_truth(eng, qs[i], preds[i], k)[1]))
    return {"recall": recalls, "n_exact": n_exact}


def routed_live(eng, qs, ps, k: int) -> dict:
    """Phase 4c's routed engine after churn: 2 % of the base rows deleted,
    0.5 % new rows upserted, then the spanning head's rows (2 per class)
    through query() and batch_query()."""
    import numpy as np

    from repro_torch.kernels import ops

    n = eng.live.base_n
    rng = np.random.default_rng(23)
    eng.delete(rng.choice(n, int(0.02 * n), replace=False))
    rows = rng.choice(n, int(0.005 * n), replace=False)
    noise = (0.01 * rng.standard_normal((rows.size, eng.vectors.shape[1]))).astype(np.float32)
    eng.upsert(eng.vectors[rows] + noise, eng.cat[rows], eng.num[rows])
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    served = [eng.query(qs[j], ps[j], k) for j in range(len(ps))]
    batched = eng.batch_query(qs, ps, k)
    launches = ops.kernel_launches()
    check(launches["masked_l2_topk"] > 0, "the live routed path launched masked_l2_topk no time")
    out = check_live_rows(eng, qs, ps, served, batched, k, "routed live", exact_of=lambda r: (
        r.result.backend, r.result.knob) == ("flat", "exact"))
    got = {r.result.backend for r in served}
    print(f"[live] routed engine after deleting {eng.live.n_deleted} base rows and upserting "
          f"{eng.live.seg_n}: the spanning head's {len(ps)} rows on backends {sorted(got)} through "
          f"query() and batch_query(): no tombstoned id, every id passes its predicate once, "
          f"{out['n_exact']} flat:exact rows equal the live ground truth; kernel launches "
          f"{launches}; dispatches {ops.dispatch_counts()}", flush=True)
    return {"launches": launches}


def _pct(v):
    import numpy as np

    v = np.asarray(v) * 1e3
    return np.percentile(v, 50), np.percentile(v, 99)


def serve_level(eng, sh, qs, ps, k: int, batch: int, tag: str, base_p50: dict) -> dict:
    """Phase 4's served queries through query() and batch_query() on the
    central and the sharded engine, with the gated row checks; prints the
    latency per plan against phase 4's, the plan mix and post recall."""
    import numpy as np

    qps, plan_qps = {}, {}

    def run(e, name):
        served = [e.query(qs[i], ps[i], k) for i in range(len(ps))]
        batched = []
        t0 = time.perf_counter()
        for s in range(0, len(ps), batch):
            batched += e.batch_query(qs[s:s + batch], ps[s:s + batch], k)
        qps[name] = len(ps) / (time.perf_counter() - t0)
        # batch_query QPS over the rows of each plan alone, beside query()'s
        # serial QPS on the same rows
        by: dict = {}
        for i, r in enumerate(served):
            by.setdefault(r.plan.strategy, []).append(i)
        for plan, rows in sorted(by.items()):
            t0 = time.perf_counter()
            for s in range(0, len(rows), batch):
                idx = rows[s:s + batch]
                e.batch_query(qs[idx], [ps[j] for j in idx], k)
            serial = len(rows) / sum(served[j].result.elapsed for j in rows)
            plan_qps[name, plan] = (len(rows) / (time.perf_counter() - t0), serial)
        return served, batched

    def exact(r):
        return r.plan.strategy in ("pre", "ipre")

    from repro_torch.kernels import ops

    l0 = ops.kernel_launches()["masked_l2_topk"]
    c_served, c_batched = run(eng, "central")
    l1 = ops.kernel_launches()["masked_l2_topk"]
    s_served, s_batched = run(sh, "sharded")
    l2 = ops.kernel_launches()["masked_l2_topk"]
    rows = check_live_rows(eng, qs, ps, c_served, c_batched, k, f"{tag} central", exact)
    check_live_rows(eng, qs, ps, s_served, s_batched, k, f"{tag} sharded")
    for i, (c, s_) in enumerate(zip(c_served, s_served)):
        check(c.plan.strategy == s_.plan.strategy, f"{tag} {i}: plans differ")
        if exact(c):
            check(np.array_equal(c.result.ids, s_.result.ids)
                  and np.array_equal(c.result.dists, s_.result.dists),
                  f"{tag} {i}: sharded exact row {s_.result.ids} differs from the central "
                  f"{c.result.ids}")
    mix: dict = {}
    for name, served in (("central", c_served), ("sharded", s_served)):
        by: dict = {}
        for r in served:
            by.setdefault(r.plan.strategy, []).append(r.result.elapsed)
        for plan, v in sorted(by.items()):
            p50, p99 = _pct(v)
            print(f"[live] {tag} {name} {plan}: {len(v)} queries, query() p50 {p50:.3f} ms "
                  f"(x{p50 / base_p50[plan]:.2f} phase 4's), p99 {p99:.3f} ms", flush=True)
        mix[name] = {p: len(v) for p, v in by.items()}
    rec = float(np.mean(rows["recall"])) if rows["recall"] else float("nan")
    print(f"[live] {tag}: plan mix {mix['central']}; post recall@10 against the live truth "
          f"{rec:.4f} over {len(rows['recall'])}; {rows['n_exact']} exact rows equal the live "
          f"ground truth (bitwise) and the independent truth (up to ties), the sharded exact rows "
          f"equal the central ones bitwise, batch rows equal query rows; batch_query (batch "
          f"{batch}) {qps['central']:.1f} QPS central, {qps['sharded']:.1f} sharded; masked_l2_topk "
          f"launches serving {l1 - l0} central, {l2 - l1} sharded", flush=True)
    print(f"[live] {tag}: batch_query QPS by plan (query() serial QPS on the same rows): "
          + "; ".join(f"{name} {plan} {b:.1f} ({q1:.1f})"
                      for (name, plan), (b, q1) in sorted(plan_qps.items())), flush=True)
    return {"exact": [(i, c.result.ids, c.result.dists) for i, c in enumerate(c_served)
                      if exact(c)], "launches": l2 - l0}


def live_index_check(eng, qs, ps, k: int, n: int = 16, n_plain: int = 8) -> int:
    """LiveIndex over the flat backend on the engine's device corpus and its
    live corpus (segment + tombstones), one predicate mask per query: equal
    bitwise to one kernel scan over base + segment under the same live mask,
    and on its first n_plain queries to the plain version over the same rows
    on the host (ids up to ties, distances within the band).  Returns the
    LiveIndex's own masked_l2_topk launches."""
    import numpy as np
    import torch

    from repro_torch.index import LiveIndex, make_backend
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import fused_masked_topk

    live = eng.live
    check(live.seg_n > 0 and live.n_deleted > 0, "LiveIndex check needs a segment and tombstones")
    li = LiveIndex(make_backend("flat", eng.vectors_dev, device="cuda"), live)
    cat = np.concatenate([live.base_cat, live.seg_cat()])
    num = np.concatenate([live.base_num, live.seg_num()])
    x_all = torch.cat([eng.vectors_dev, live.seg_vectors_dev()])
    x_host = x_all.cpu()
    alive = live.alive_mask()
    launches = 0
    for i in range(n):
        m = ps[i].eval(cat, num)
        l0 = ops.kernel_launches()["masked_l2_topk"]
        d, ids = li.search_masked(qs[i:i + 1], m, k)
        launches += ops.kernel_launches()["masked_l2_topk"] - l0
        mt = torch.as_tensor(m & alive)
        q = torch.as_tensor(qs[i:i + 1])
        wd, wi = fused_masked_topk(q.cuda(), x_all, mt.cuda(), k)
        wd, wi = wd.cpu().numpy(), wi.cpu().numpy()
        check(np.array_equal(ids, wi) and np.array_equal(d, wd),
              f"LiveIndex row {i}: {ids} {d} differs from one scan of the live rows {wi} {wd}")
        check(not live.is_deleted(ids[ids >= 0]).any(), f"LiveIndex row {i}: a dead id")
        if i < n_plain:
            pd, pi = fused_masked_topk(q, x_host, mt, k)
            check(same_up_to_ties(qs[i], ids, d, pi.numpy(), pd.numpy()),
                  f"LiveIndex row {i}: {ids} {d} differs from the plain version "
                  f"{pi.numpy()} {pd.numpy()}")
    check(launches == 2 * n, f"LiveIndex launched masked_l2_topk {launches} times for {n} "
                             "searches, not one base and one segment scan each")
    print(f"[live] LiveIndex(flat) over {live.base_n} base rows, {live.seg_n} segment rows and "
          f"{live.n_deleted} tombstones: {n} searches equal one kernel scan of the live rows "
          f"bitwise and, on {n_plain}, the plain version up to ties; masked_l2_topk launches "
          f"{launches}", flush=True)
    del x_all, x_host, li
    torch.cuda.empty_cache()
    return launches


def live_phase(mp: dict, k: int = 10, batch: int = 64, n_shards: int = 4) -> dict:
    import gc

    import numpy as np
    import torch

    from repro_torch import carry
    from repro_torch.core import EngineConfig, FilteredANNEngine
    from repro_torch.dist import HeartbeatMonitor, replan_mesh
    from repro_torch.kernels import ops
    from repro_torch.serve import ShardedANNEngine

    ds, qs, ps, eng4 = mp["ds"], mp["qs"], mp["preds"], mp["engine"]
    base_p50 = {}
    for r in mp["served"]:
        base_p50.setdefault(r.plan.strategy, []).append(r.result.elapsed)
    # phase 4's p50 per plan; pre, which its planner seldom picks, is the
    # pre executor's median over phase 4's direct runs
    base_p50 = {p: _pct(v)[0] for p, v in base_p50.items()}
    base_p50.setdefault("pre", mp["pre_ms"])
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    t0 = time.perf_counter()
    eng = carried_engine(eng4)
    t1 = time.perf_counter()
    sh = ShardedANNEngine(eng, n_shards=n_shards)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    views = all(s.pre_exec.vectors.data_ptr() == eng.vectors_dev[int(s.ids[0])].data_ptr()
                for s in sh.shards)
    check(views, "a shard's device rows are not a view of the engine's corpus")
    print(f"[live] plain engine {t1 - t0:.2f} s (build + carried planner, GBM and IVF layout), "
          f"{n_shards} shards {t2 - t1:.2f} s (views of the device corpus, an IVF each); "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated", flush=True)

    # the segment: fresh rows, ids= replacements of live rows, and exact
    # copies of the base rows phase 4's exact plans returned first
    n, dim = eng.vectors.shape
    rng = np.random.default_rng(31)
    n_seg = int(SEG_FRAC * n)
    top = np.unique([r.result.ids[0, j] for r in mp["served"] if r.plan.strategy in ("pre", "ipre")
                     for j in range(3) if r.result.ids[0, j] >= 0])
    copies = top[:600]
    check(copies.size >= 64, f"only {copies.size} base rows to copy")
    protected = np.zeros(n, bool)
    protected[copies] = True
    pool = rng.permutation(np.flatnonzero(~protected))
    replace = pool[: n_seg // 50]
    pool = pool[replace.size:]
    src = rng.choice(n, max(0, n_seg - copies.size - replace.size))
    fresh_v = (eng.vectors[src] + 0.05 * rng.standard_normal((src.size, dim))).astype(np.float32)
    t0 = time.perf_counter()
    sh.upsert(eng.vectors[replace] + 0.01, eng.cat[replace], eng.num[replace], ids=replace)
    copy_h = sh.upsert(eng.vectors[copies], eng.cat[copies], eng.num[copies])
    for part in np.array_split(np.arange(src.size), 8):
        sh.upsert(fresh_v[part], eng.cat[src[part]], eng.num[src[part]])
    up_s = time.perf_counter() - t0
    n_up = eng.live.seg_n
    del_s, deleted = 0.0, replace.size
    exact_before = None
    serving = 0     # masked_l2_topk launches of the serving runs alone
    for frac in TOMBSTONE_FRACS:
        target = int(frac * n)
        kill = pool[: target - deleted]
        pool = pool[kill.size:]
        t0 = time.perf_counter()
        sh.delete(kill)
        del_s += time.perf_counter() - t0
        deleted = target
        print(f"[live] level {frac:.2f}: {eng.live.n_deleted} tombstones "
              f"({eng.live.tombstone_frac:.4f} of {eng.live.n_total} rows), segment "
              f"{eng.live.seg_n} rows ({eng.live.segment_frac:.4f})", flush=True)
        lvl = serve_level(eng, sh, qs, ps, k, batch, f"tomb {frac:.2f}", base_p50)
        exact_before = lvl["exact"]
        serving += lvl["launches"]
    serving += live_index_check(eng, qs, ps, k)
    profile_runs({"central query()": lambda i: eng.query(qs[i], ps[i], k),
                  "sharded query()": lambda i: sh.query(qs[i], ps[i], k)}, 40, tag="live")
    n_ties = 0
    for i, ids, _ in exact_before:
        row = ids[0].tolist()
        for b, c in zip(copies.tolist(), copy_h.tolist()):
            if b in row and c in row:
                check(row.index(c) == row.index(b) + 1,
                      f"query {i}: the copy {c} of base row {b} does not come right after it: {row}")
                n_ties += 1
    check(n_ties > 0, "no served exact row held a base row and its copy")
    print(f"[live] upsert {n_up} rows in {up_s:.2f} s ({n_up / up_s:.0f} rows/s; {replace.size} "
          f"ids= replacements, {copies.size} exact copies of base rows), delete "
          f"{eng.live.n_deleted} rows in {del_s:.2f} s ({eng.live.n_deleted / del_s:.0f} rows/s); "
          f"{n_ties} served exact rows hold a base row and its copy, the copy right after it",
          flush=True)

    # a shard stops beating: replan to 3 and reshard the live deployment
    hb = HeartbeatMonitor(n_hosts=n_shards, timeout=0.05)
    events, now = [], 0.0
    for step in range(12):
        now += 0.01
        for si in range(n_shards):
            if not (si == 2 and step >= 4):
                hb.beat(si, now)
        events += hb.check(step, now)
        sh.query(qs[step], ps[step], k)
    check([(e.kind, e.host) for e in events] == [("dead_host", 2)], f"fault events {events}")
    shape, _ = replan_mesh(len(hb.alive), model_parallel=1)
    t0 = time.perf_counter()
    sh.reshard(shape[0])
    reshard_s = time.perf_counter() - t0
    check(len(sh.shards) == 3, "reshard did not give 3 shards")
    for i, ids, dists in exact_before:
        r = sh.query(qs[i], ps[i], k)
        check(np.array_equal(r.result.ids, ids) and np.array_equal(r.result.dists, dists),
              f"query {i} after reshard: {r.result.ids} differs from {ids}")
    print(f"[live] shard 2 stopped beating: {events[0]}; replan_mesh -> {shape}; reshard(3) "
          f"{reshard_s:.2f} s; {len(exact_before)} exact rows equal the central engine's bitwise",
          flush=True)

    # compaction: exact rows map through id_map, and equal a fresh build
    t0 = time.perf_counter()
    id_map = sh.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    fresh = FilteredANNEngine(eng.vectors, eng.cat, eng.num, EngineConfig(device="cuda")).build()
    carry.install(fresh, gbm=carry.gbm_state(eng4.estimator.model),
                  planner=eng4.planner.state_dict())
    n_cmp = 0
    for i, ids, dists in exact_before:
        want = np.where(ids >= 0, id_map[np.maximum(ids, 0)], -1)
        for e in (eng, sh, fresh):
            r = e.query(qs[i], ps[i], k)
            if r.plan.strategy not in ("pre", "ipre"):
                continue
            n_cmp += 1
            check(np.array_equal(r.result.ids, want) and np.array_equal(r.result.dists, dists),
                  f"query {i} after compaction: {r.result.ids} differs from {want}")
    check(n_cmp > 0, "no exact row to compare after compaction")
    launches = ops.kernel_launches()
    check(serving > 0, "phase 4d's serving launched masked_l2_topk no time")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[live] compact (central + re-shard to 3) {compact_s:.2f} s (central rebuild "
          f"{eng.build_time_['compaction']:.2f} s) to {eng.vectors.shape[0]} rows; {n_cmp} exact "
          f"rows of the compacted central, sharded and a fresh build equal the live rows through "
          f"id_map bitwise; peak {peak:.2f} GB allocated in 4d", flush=True)
    print(f"[live] masked_l2_topk launches in 4d: {serving} serving (query() and batch_query() "
          f"at each level, LiveIndex), {launches['masked_l2_topk']} in the whole phase (builds, "
          f"checks, profiling, reshard and compaction included); kernel launches {launches}",
          flush=True)
    del fresh, sh, eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[live] phase 4d (plain engine, shards, churn, reshard, compaction) took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": {"masked_l2_topk": serving}, "upsert_rows_s": n_up / up_s, "delete_rows_s": deleted / del_s,
            "compact_s": compact_s, "peak_gb": peak}


# ----------------------------------------------------------------------
# phase 4e: the serving runtime, observability, checkpoints and the fleet
# ----------------------------------------------------------------------
RUNTIME_LOADS = (0.5, 2.0, 8.0)   # x 1 / ServiceModel().estimate(1), as runtime_bench.py
RUNTIME_READS = 400
POOL = 16                         # predicates drawn (zipf 1.2) by a trace
FLEET_TRAIN = 64                  # phase 4's training queries each tenant fits on
FLEET_TARGETS = (0.95, 0.60)      # fleet_bench.py: quiet SLO hit rate, fleet / shared
PROM_LINE = r'^(#.*|[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*",?)*\})? \S+)$'


def _launches() -> int:
    from repro_torch.kernels import ops

    return ops.kernel_launches()["masked_l2_topk"]


def _idle(wall, busy) -> str:
    if busy is None:
        return "device time not measured"
    return f"device busy {busy:.3f} s of {wall:.3f} s wall, idle share {1 - busy / wall:.3f}"


def check_served(eng, req, res, truth, tag: str) -> bool:
    """A served read: k slots, every id passes its predicate once, and an
    exact plan equals ``truth`` up to ties.  Returns whether it was exact."""
    import numpy as np

    ids = res.result.ids[0][res.result.ids[0] >= 0]
    c, m = eng.live.row_attrs(ids)
    check(res.result.ids.shape == (1, req.k) and bool(req.pred.eval(c, m).all()),
          f"{tag} rid {req.rid}: an id fails its predicate")
    check(len(set(ids.tolist())) == ids.size, f"{tag} rid {req.rid}: an id came back twice")
    if not exact_plan(res.plan):
        return False
    td, ti = truth(req.query, req.pred)
    check(same_up_to_ties(np.asarray(req.query, np.float32), res.result.ids, res.result.dists,
                          ti, td),
          f"{tag} rid {req.rid} ({res.plan.strategy}): {res.result.ids} {res.result.dists} "
          f"differs from the truth {ti} {td}")
    return True


def carried_engine(src):
    """A plain engine over src's base rows, on src's device, with src's
    planner, GBM and IVF layout carried."""
    from repro_torch import carry
    from repro_torch.core import EngineConfig, FilteredANNEngine

    live = src.live
    eng = FilteredANNEngine(live.base_vectors, live.base_cat, live.base_num,
                            EngineConfig(device=src.device.type)).build()
    return carry.install(eng, centroids=src.ivf.centroids.cpu().numpy(),
                         assignment=carry.ivf_assignment(src.ivf),
                         gbm=carry.gbm_state(src.estimator.model),
                         planner=src.planner.state_dict())


def runtime_replays(eng, qs, pool, k: int) -> dict:
    """(a) runtime_bench.py's traffic: Poisson and bursty traces of 400
    reads at 0.5, 2 and 8 x the single-request virtual capacity through
    OnlineRuntime(max_batch=64, max_wait=0.005), each replayed twice."""
    import numpy as np

    from repro_torch.runtime import OnlineRuntime, SchedulerConfig, ServiceModel, make_trace

    cfg = SchedulerConfig(max_batch=64, max_wait=0.005)
    cap = 1.0 / ServiceModel().estimate(1)
    truth = TruthMemo(eng, k)
    serving, n_exact, out = 0, 0, {}
    for si, shape in enumerate(("poisson", "bursty")):
        for li, load in enumerate(RUNTIME_LOADS):
            tag = f"[runtime] {shape} x{load}"
            trace = make_trace(shape, qs, pool, RUNTIME_READS, load * cap, k=k,
                               seed=100 + 10 * si + li)
            l0 = _launches()
            rep = OnlineRuntime(eng, cfg).run_trace(trace)
            serving += _launches() - l0
            again = OnlineRuntime(eng, cfg).run_trace(trace)
            check(rep.batches == again.batches, f"{tag}: replay batches differ")
            check(rep.telemetry.counters() == again.telemetry.counters(),
                  f"{tag}: replay counters differ")
            rids = sorted(r for b in rep.batches for r in b)
            check(rids == list(range(len(trace))) and sorted(rep.results) == rids,
                  f"{tag}: not every request answered exactly once")
            for r in trace:
                check(np.array_equal(rep.ids(r.rid), again.ids(r.rid)),
                      f"{tag}: replay ids differ for rid {r.rid}")
                n_exact += check_served(eng, r, rep.results[r.rid], truth, tag)
            t0 = time.perf_counter()
            for r in trace:
                eng.query(r.query, r.pred, r.k)
            naive_qps = len(trace) / (time.perf_counter() - t0)
            c = snap = rep.telemetry.snapshot()
            hit = {t: c["deadline_met"].get(t, 0) / max(1, c["deadline_met"].get(t, 0)
                                                        + c["deadline_missed"].get(t, 0))
                   for t in sorted(set(c["deadline_met"]) | set(c["deadline_missed"]))}
            lat = snap["latency_virtual"]
            out[(shape, load)] = {"qps": snap["wall"]["throughput_qps"], "naive_qps": naive_qps}
            print(f"{tag}: {len(trace)} reads at {load * cap:.1f} virtual qps in "
                  f"{c['n_batches']} batches (mean {len(trace) / c['n_batches']:.1f}); measured "
                  f"{snap['wall']['throughput_qps']:.1f} QPS vs a per-request query() loop "
                  f"{naive_qps:.1f} ({snap['wall']['throughput_qps'] / naive_qps:.2f}x; "
                  f"runtime_bench's target 2x, not gated); virtual p50 {lat['p50'] * 1e3:.3f} / "
                  f"p99 {lat['p99'] * 1e3:.3f} ms (virtual); deadline hit rate (virtual) "
                  + ", ".join(f"{t} {v:.3f}" for t, v in hit.items())
                  + "; plans " + ", ".join(f"{p} {n}" for p, n in c["plan_counts"].items() if n),
                  flush=True)
    check(n_exact > 0, "no exact-plan row in the runtime replays")
    trace = make_trace("poisson", qs, pool, RUNTIME_READS, 2.0 * cap, k=k, seed=111)
    rep, wall, busy, _ = _device_busy(eng.device, lambda: OnlineRuntime(eng, cfg).run_trace(trace))
    print(f"[runtime] one replay (poisson x2.0) under torch.profiler: {_idle(wall, busy)}; "
          f"{n_exact} exact-plan rows equal an l2_topk truth up to ties; replays bitwise equal; "
          f"{serving} masked_l2_topk launches in the measured replays", flush=True)
    return {"launches": serving, "rows": out}


class LiveChecked:
    """A runtime backend that checks every served batch on the spot, before
    the next writes (``check_live_row``: exact rows against the live
    ground_truth bitwise and the independent live truth up to ties).
    ``launches`` counts the masked_l2_topk launches of the runtime's own
    batch_query calls, not those of the checks."""

    def __init__(self, eng):
        self.eng, self.n_exact, self.n_rows, self.launches = eng, 0, 0, 0

    def upsert(self, *a, **kw):
        return self.eng.upsert(*a, **kw)

    def delete(self, *a, **kw):
        return self.eng.delete(*a, **kw)

    def maybe_compact(self):
        return self.eng.maybe_compact()

    def batch_query(self, queries, preds, k):
        l0 = _launches()
        out = self.eng.batch_query(queries, preds, k)
        self.launches += _launches() - l0
        for j, res in enumerate(out):
            exact = exact_plan(res.plan)
            check_live_row(self.eng, queries[j], preds[j], res, k,
                           f"[writes] row {self.n_rows}", exact)
            self.n_rows += 1
            self.n_exact += exact
        return out


def writes_and_checkpoint(eng, ds, eng4, qs, pool, train_q, k: int) -> int:
    """(b) a Poisson trace with write_frac 0.1 (upserts of phase 4's
    training query vectors, held out of its served set; deletes from a pool
    of base handles), then a checkpoint of mutation_state() restored onto a
    fresh engine with the same carried state."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.ckpt import Checkpointer
    from repro_torch.runtime import OnlineRuntime, SchedulerConfig, ServiceModel, poisson_trace

    n = eng.vectors.shape[0]
    rng = np.random.default_rng(41)
    src = rng.choice(n, len(train_q), replace=False)
    wc = (np.asarray(train_q, np.float32), eng.cat[src], eng.num[src])
    cap = 1.0 / ServiceModel().estimate(1)
    trace = poisson_trace(qs, pool, RUNTIME_READS, 2.0 * cap, k=k, seed=7, write_frac=0.1,
                          write_corpus=wc, delete_pool=rng.choice(n, 4000, replace=False))
    backend = LiveChecked(eng)
    rep = OnlineRuntime(backend, SchedulerConfig(max_batch=64, max_wait=0.005)).run_trace(trace)
    serving = backend.launches
    c = rep.telemetry.counters()
    check(c["n_upserts"] > 0 and c["n_deletes"] > 0, f"[writes] no writes served: {c}")
    check(backend.n_exact > 0, "[writes] no exact row to check")
    print(f"[writes] {len(trace)} requests ({c['n_upserts']} upserted rows, {c['n_deletes']} "
          f"deleted, {c['n_compactions']} compactions) in {c['n_batches']} batches: no tombstoned "
          f"id in {backend.n_rows} reads, {backend.n_exact} exact rows equal the live ground "
          f"truth bitwise and an l2_topk live truth up to ties; {serving} masked_l2_topk "
          f"launches in the runtime's batch_query calls", flush=True)

    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        t0 = time.perf_counter()
        ck.save(1, eng.mutation_state(), meta={"corpus_generation": eng.corpus_generation})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck.save_async(2, eng.mutation_state(), meta={"corpus_generation": eng.corpus_generation})
        ck.wait()
        async_s = time.perf_counter() - t0
        step = os.path.join(d, "step_00000002")
        n_bytes = sum(os.path.getsize(os.path.join(step, f)) for f in os.listdir(step))
        t0 = time.perf_counter()
        fresh = carried_engine(eng4)
        _sync(fresh.device)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh.load_mutation_state(ck.restore(ck.latest_step(), fresh.mutation_state()))
        restore_s = time.perf_counter() - t0
        check(ck.steps() == [1, 2] and ck.latest_meta()["corpus_generation"]
              == eng.corpus_generation, f"checkpoint steps {ck.steps()}")
    check((fresh.live.n_total, fresh.live.live_count) == (eng.live.n_total, eng.live.live_count),
          "the restored engine's live rows differ")
    # every served row (exact plans, and post rows over the same carried
    # IVF layout) and the exact live truth of every query, bitwise; writes
    # move n, which flips the carried planner (ROADMAP Queue 3), so the
    # exact truth is compared whatever the plan
    n_exact = 0
    for i in range(64):
        pred = pool[i % len(pool)]
        a, b = eng.query(qs[i], pred, k), fresh.query(qs[i], pred, k)
        n_exact += exact_plan(a.plan)
        check(a.plan.strategy == b.plan.strategy
              and np.array_equal(a.result.ids, b.result.ids)
              and np.array_equal(a.result.dists, b.result.dists),
              f"[ckpt] query {i}: restored {b.result.ids} differs from {a.result.ids}")
        check(np.array_equal(eng.ground_truth(qs[i], pred, k), fresh.ground_truth(qs[i], pred, k)),
              f"[ckpt] query {i}: the restored engine's exact live truth differs")
    print(f"[ckpt] mutation_state: save {save_s:.3f} s, save_async + wait {async_s:.3f} s, "
          f"{n_bytes} bytes on disk; fresh engine {build_s:.2f} s (build + carried state), "
          f"restore {restore_s:.3f} s; 64 served rows ({n_exact} exact plans) and 64 exact "
          f"live truths equal the live engine's bitwise", flush=True)
    del fresh
    return serving


def observability(eng, qs, pool, k: int) -> int:
    """(c) Tracer, RecallProbe and OnlineFeedback over one runtime."""
    import re

    from repro_torch.kernels.masked_l2 import SMEM_MAX
    from repro_torch.obs import (RecallProbe, Tracer, publish_kernel_budget,
                                 publish_kernel_dispatch, publish_stats, span_summary)
    from repro_torch.runtime import (FeedbackConfig, OnlineFeedback, OnlineRuntime,
                                     SchedulerConfig, ServiceModel, poisson_trace)

    cfg = SchedulerConfig(max_batch=64, max_wait=0.005)
    trace = poisson_trace(qs, pool, RUNTIME_READS, 2.0 / ServiceModel().estimate(1), k=k, seed=9)

    def cold(**kw):
        eng.plan_cache.clear()
        eng.pred_cache.clear()
        rep = OnlineRuntime(eng, cfg, **kw).run_trace(trace)
        eng.set_tracer(None)
        return rep

    # stats()'s kernel_dispatch moves over a traced replay by what its
    # execute spans' kernel_* attrs add up to, kernel by kernel
    d0 = eng.stats()["kernel_dispatch"]
    l0 = _launches()
    ta = Tracer()
    cold(tracer=ta)
    serving = _launches() - l0
    delta = {n: c - d0.get(n, 0) for n, c in eng.stats()["kernel_dispatch"].items()
             if c != d0.get(n, 0)}
    spans: dict = {}
    for s in ta.spans():
        if s.name == "execute":
            for key, v in s.attrs.items():
                if key.startswith("kernel_"):
                    spans[key[len("kernel_"):]] = spans.get(key[len("kernel_"):], 0) + v
    check(spans == delta and delta.get("fused_masked_topk", 0) > 0,
          f"execute spans hold dispatches {spans}, stats()' kernel_dispatch moved by {delta}")
    tb = Tracer()
    cold(tracer=tb)
    check(ta.deterministic_tree() == tb.deterministic_tree(),
          "two cold traced replays gave different span trees")
    tc = Tracer()
    _, wall, busy, _ = _device_busy(eng.device, lambda: cold(tracer=tc))
    rows = span_summary(tc)
    print(f"[obs] {sum(1 for _ in ta.spans())} spans a replay, equal across two cold replays; "
          f"execute spans' dispatches {spans} = stats()' kernel_dispatch delta; span_summary (kernel: rows "
          f"are enqueue walls, not device time) beside the profiler: {_idle(wall, busy)}", flush=True)
    for r in rows[:8]:
        print(f"[obs]   {r['stage']:<28} count {r['count']:>5}  wall {r['wall_s'] * 1e3:9.3f} ms  "
              f"self {r['self_s'] * 1e3:9.3f} ms")
    probe = RecallProbe(rate=0.05, seed=0)
    fb = OnlineFeedback(eng, FeedbackConfig(sample_rate=0.25, refit_every=32, min_examples=32,
                                            seed=0))
    t0 = time.perf_counter()
    rep = cold(tracer=Tracer(), probe=probe, feedback=fb)
    fb_s = time.perf_counter() - t0
    check(fb.n_refits >= 1, f"feedback attempted no refit: {fb.stats()}")
    check(probe.n_sampled > 0, "the probe sampled nothing")
    reg = rep.telemetry.registry
    publish_stats(reg, eng.stats())
    publish_kernel_dispatch(reg)
    publish_kernel_budget(reg)
    probe.publish(reg)
    fb.publish(reg)
    text = reg.prometheus_text()
    bad = [line for line in text.splitlines() if not re.match(PROM_LINE, line)]
    check(not bad, f"prometheus_text() lines that do not parse: {bad[:3]}")
    print(f"[obs] probe (rate 0.05, {probe.n_sampled} of {probe.n_seen} sampled) recall by "
          "class: " + ", ".join(f"{c} {v['recall']:.4f} (n={v['count']})"
                                for c, v in probe.estimates().items()), flush=True)
    print(f"[obs] feedback (wall-clock shadow labels, sample 0.25, refit every 32): "
          f"{fb.stats()} in {fb_s:.1f} s; prometheus_text() {len(text.splitlines())} lines parse",
          flush=True)
    print(f"[obs] smem budget (bytes per block; sm_90 allows {SMEM_MAX}): "
          + ", ".join(f"{lbl['kernel']} qt {lbl['qt']} {int(v)}"
                      f"{'' if reg.value('repro_kernel_smem_fits_sm90', **lbl) else ' (no)'}"
                      for lbl, v in reg.series("repro_kernel_smem_bytes")), flush=True)
    return serving


def fleet_phase(ds, qs, pool, train, k: int, device: str) -> int:
    """(d) fleet_bench.py's headline: three tenants over an even split of
    the rows, two quiet Poisson tenants at 0.3 of the fair load and one
    noisy bursty tenant at 8x, FleetRuntime (DRR, admission, autoscale)
    against the shared-queue baseline on one trace."""
    import tempfile

    import numpy as np

    from repro_torch.ckpt import Checkpointer
    from repro_torch.core import EngineConfig
    from repro_torch.fleet import (AdmissionController, AutoscaleConfig, CollectionSchema, Fleet,
                                   FleetConfig, FleetRuntime, FleetServiceModel, TenantCollection)
    from repro_torch.runtime import TenantTraceSpec, multi_tenant_trace

    batch = 64
    svc = FleetServiceModel()
    capacity = batch / (svc.dispatch + batch * min(svc.per_row.values()) / 2 + svc.fanout * 2)
    fair = capacity / 3
    quiet, noisy = {"standard": 0.9, "batch": 0.1}, {"standard": 1.0}
    tenants = [("checkout", quiet, "poisson", 0.3, 0.30), ("catalog", quiet, "poisson", 0.3, 0.30),
               ("analytics", noisy, "bursty", 8.0, 0.15)]
    n_each = ds.vectors.shape[0] // len(tenants)
    fleet = Fleet(total_shards=8)
    specs, times = [], []
    qt, pt = train
    for ti, (name, mix, kind, frac, duration) in enumerate(tenants):
        rows = slice(ti * n_each, (ti + 1) * n_each)
        is_noisy = kind == "bursty"
        schema = CollectionSchema(name=name, dim=ds.vectors.shape[1], n_shards=1 if is_noisy else 2,
                                  admit_rate=0.6 * fair if is_noisy else None,
                                  admit_burst=0.3 * fair if is_noisy else None)
        t0 = time.perf_counter()
        col = fleet.create(schema, ds.vectors[rows], ds.cat[rows], ds.num[rows],
                           config=EngineConfig(device=device),
                           train=(qt[:FLEET_TRAIN], pt[:FLEET_TRAIN]), k=k)
        _sync(col.engine.device)
        bt = col.engine.build_time_
        times.append(f"{name} {time.perf_counter() - t0:.2f} s (fit {bt['fit']:.2f}, ivf "
                     f"{bt['ivf']:.2f})")
        rate = frac * fair
        specs.append(TenantTraceSpec(name, qs, pool, int(rate * duration), rate, kind=kind, k=k,
                                     tier_mix=mix, burst_factor=8.0, burst_frac=0.25, cycle=0.05))
    trace = multi_tenant_trace(specs, seed=42)
    print(f"[fleet] {len(tenants)} tenants of {n_each} rows ({', '.join(times)}); fair share "
          f"{fair:.1f} virtual qps each; {len(trace)} requests", flush=True)

    def fleet_run():
        return FleetRuntime(fleet, FleetConfig(max_batch=batch, fair=True),
                            admission=AdmissionController.for_fleet(fleet),
                            autoscale=AutoscaleConfig(eval_every=0.05, min_window=24,
                                                      grow_miss_rate=0.15, shrink_miss_rate=0.02,
                                                      cooldown=0.05)).run_trace(trace)

    l0 = _launches()
    t0 = time.perf_counter()
    shared = FleetRuntime(fleet, FleetConfig(max_batch=batch, fair=False)).run_trace(trace)
    shared_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r1 = fleet_run()
    fleet_s = time.perf_counter() - t0
    serving = _launches() - l0
    r2 = fleet_run()
    check(r1.batches == r2.batches and r1.rejected == r2.rejected, "fleet replay batches/rejects")
    check(r1.telemetry.counters() == r2.telemetry.counters(), "fleet replay counters differ")
    check([e.as_dict() for e in r1.scale_events] == [e.as_dict() for e in r2.scale_events],
          "fleet replay scale events differ")
    check(sorted(r1.results) == sorted(r2.results), "fleet replay answered other rids")
    for rid in r1.results:
        check(np.array_equal(r1.ids(rid), r2.ids(rid)), f"fleet replay ids differ for rid {rid}")
    truths = {n: TruthMemo(fleet[n].engine, k) for n in fleet.names()}
    n_exact = 0
    by_rid = {r.rid: r for r in trace}
    for tag, rep in (("[fleet]", r1), ("[fleet shared]", shared)):
        for rid, res in rep.results.items():
            req = by_rid[rid]
            n_exact += check_served(fleet[req.tenant].engine, req, res, truths[req.tenant], tag)
    check(n_exact > 0, "[fleet] no exact row to check")
    names = fleet.names()
    quiet_names = [t[0] for t in tenants if t[2] == "poisson"]
    hit = {n: (r1.slo_hit_rate(n), shared.slo_hit_rate(n)) for n in names}
    grows = [e for e in r1.scale_events if e.action == "grow"]
    shrinks = [e for e in r1.scale_events if e.action == "shrink"]
    print(f"[fleet] SLO hit rate (virtual) fleet / shared: "
          + ", ".join(f"{n} {a:.4f} / {b:.4f}" for n, (a, b) in hit.items())
          + f"; quiet min {min(hit[n][0] for n in quiet_names):.4f} (fleet_bench's target "
          f"{FLEET_TARGETS[0]}) / {min(hit[n][1] for n in quiet_names):.4f} (at most "
          f"{FLEET_TARGETS[1]}), not gated; rejected {len(r1.rejected)}", flush=True)
    print(f"[fleet] scale events: {len(grows)} grow, {len(shrinks)} shrink, "
          f"{len(r1.scale_events) - len(grows) - len(shrinks)} other: "
          + "; ".join(f"{e.t:.3f} {e.tenant} {e.action} {e.from_shards}->{e.to_shards}"
                      for e in r1.scale_events[:8]), flush=True)
    print(f"[fleet] shared run {shared_s:.2f} s, fleet run {fleet_s:.2f} s (reshards included); "
          f"two fleet runs equal (batches, rejects, ids, counters, scale events); {n_exact} exact "
          f"rows equal an l2_topk truth up to ties; {serving} masked_l2_topk launches in the "
          f"shared and first fleet runs", flush=True)
    t0 = time.perf_counter()
    fleet["checkout"].reshard(3)
    _sync(fleet["checkout"].engine.device)
    reshard_s = time.perf_counter() - t0
    fleet.reset_shards()

    # writes on one tenant, then save and restore onto fresh collections
    cat = fleet["catalog"]
    rng = np.random.default_rng(43)
    src = rng.choice(n_each, 64, replace=False)
    cat.upsert(np.asarray(qt[:64], np.float32), cat.engine.cat[src], cat.engine.num[src])
    cat.delete(rng.choice(n_each, 256, replace=False))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        t0 = time.perf_counter()
        fleet.save(ck, step=1)
        save_s = time.perf_counter() - t0
        fresh = Fleet(total_shards=8)
        t0 = time.perf_counter()
        for n in names:
            fresh.add(TenantCollection(fleet[n].schema, carried_engine(fleet[n].engine)))
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh.restore(ck)
        restore_s = time.perf_counter() - t0
    n_cmp = 0
    for n in names:
        check(fresh[n].manifest()["live_count"] == fleet[n].manifest()["live_count"]
              and fresh[n].n_shards == fleet[n].n_shards, f"[fleet] {n}: restored manifest differs")
        for i in range(24):
            a, b = fleet[n].query(qs[i], pool[i % len(pool)], k), fresh[n].query(qs[i], pool[i % len(pool)], k)
            if exact_plan(a.plan):
                n_cmp += 1
                check(np.array_equal(a.result.ids, b.result.ids)
                      and np.array_equal(a.result.dists, b.result.dists),
                      f"[fleet] {n} query {i}: restored {b.result.ids} differs from {a.result.ids}")
    check(n_cmp > 0, "[fleet] no exact row to compare after restore")
    print(f"[fleet] reshard(3) of a {n_each}-row tenant {reshard_s:.2f} s; save {save_s:.3f} s, "
          f"3 fresh collections {build_s:.2f} s, restore {restore_s:.2f} s; {n_cmp} exact rows "
          f"equal bitwise after restore", flush=True)
    del fresh, fleet
    return serving


def runtime_phase(mp: dict, k: int = 10) -> dict:
    """Phase 4e: the runtime, checkpoints, observability and the fleet over
    a plain engine at phase 4's size, its state carried from phase 4."""
    import gc

    import torch

    from repro_torch.kernels import ops

    ds, qs, ps, eng4 = mp["ds"], mp["qs"], mp["preds"], mp["engine"]
    pool = ps[:POOL]
    t_phase = time.perf_counter()
    if eng4.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    eng = carried_engine(eng4)
    _sync(eng.device)
    print(f"[runtime] plain engine {time.perf_counter() - t0:.2f} s (build + phase 4's planner, "
          f"GBM and IVF layout)", flush=True)
    serving = runtime_replays(eng, qs, pool, k)["launches"]
    serving += writes_and_checkpoint(eng, ds, eng4, qs, pool, mp["train"][0], k)
    serving += observability(eng, qs, pool, k)
    del eng
    gc.collect()
    if eng4.device.type == "cuda":
        torch.cuda.empty_cache()
    serving += fleet_phase(ds, qs, ps[:24], mp["train"], k, eng4.device.type)
    gc.collect()
    peak = 0.0
    if eng4.device.type == "cuda":
        torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated() / 1e9
    check(serving > 0, "phase 4e's serving launched masked_l2_topk no time")
    print(f"[runtime] masked_l2_topk launches in 4e: {serving} serving, "
          f"{ops.kernel_launches()['masked_l2_topk']} in the whole phase; peak {peak:.2f} GB "
          f"allocated; phase 4e took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": {"masked_l2_topk": serving}}


# ----------------------------------------------------------------------
# phase 3b: the decode attention kernel against its plain version
# ----------------------------------------------------------------------
def decode_bound(lengths, s: int, kv: int, gq: int, dh: int, elem: int, scale_bytes: int = 0):
    """(ms, "bytes" or "operations"): the least time for one call.  Each K/V
    byte below a row's length is read once (with int8, ``scale_bytes`` = 4
    more a position, head and tensor: its scale), q read and out written
    once; 4 flops (q.k and p.v) per K/V element per query head, on the fp32
    CUDA cores the kernel uses."""
    pos = sum(min(int(n), s) for n in lengths)
    b = len(lengths)
    bytes_ = pos * kv * (dh * elem + scale_bytes) * 2 + 2 * b * kv * gq * dh * 4 + 4 * b
    flops = 4 * pos * kv * gq * dh
    tb, tf = bytes_ / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def sdpa_call(q, k, v, length):
    """The library yardstick, timed here and used nowhere in the port: one
    scaled_dot_product_attention call with GQA and a boolean length mask."""
    import torch

    b, kv, gq, dh = q.shape
    mask = (torch.arange(k.shape[2], device=q.device)[None, :] < length[:, None])[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q.reshape(b, kv * gq, 1, dh).to(k.dtype), k, v, attn_mask=mask, enable_gqa=True)


def time_decode_calls(fns: dict, reps: int, tag: str):
    """(CUDA-event ms, profiler device ms, kernels per call of "kernel") of
    each call in ``fns``: the kernel over 20 calls and 10 profiled, the
    others over ``reps`` and 3 profiled; the kernel must be one launch."""
    wall = {n: cuda_ms(f, 20 if n == "kernel" else reps) for n, f in fns.items()}
    prof = {n: device_ms(f, 10, expect=1) if n == "kernel" else device_ms(f, 3)
            for n, f in fns.items()}
    on_card = {n: p[0] for n, p in prof.items()}
    check(all(v > 0 for v in on_card.values()),
          f"decode_attention {tag}: torch.profiler saw no device time in three windows: {on_card}")
    per_call = prof["kernel"][1]
    check(per_call == 1, f"decode_attention {tag}: {per_call} CUDA kernels per call, not 1")
    return wall, on_card, per_call


def ragged_lengths(b: int, s: int, rng, chunk: int) -> list:
    """Lengths in [1, S] with S, 1 and one in the middle of a chunk."""
    if b == 1:
        return [s]
    lengths = [int(n) for n in rng.integers(1, s + 1, b)]
    lengths[0], lengths[-1] = s, 1
    if b > 2:
        lengths[1] = (s // 2 // chunk) * chunk + chunk // 2 + 3
    return lengths


def decode_checks() -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import chunk_positions, decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    rows, max_err = {}, 0.0
    names = {torch.bfloat16: "bf16", torch.float32: "f32"}
    cases = [(b, 8, 5, s, 128, dt, True) for dt in (torch.bfloat16, torch.float32)
             for s in (2088, 32768) for b in (1, 8, 32)]
    # the reference's kernel-test shapes (tests/test_kernels.py), and the
    # other head widths and group sizes the kernel takes
    cases += [(b, kv, gq, s, dh, torch.float32, False) for b, kv, gq, s, dh in
              [(2, 4, 2, 1024, 64), (1, 2, 8, 512, 128), (3, 1, 4, 1536, 64),
               (2, 8, 1, 512, 128), (3, 2, 4, 300, 32)]]
    cases += [(2, 2, 16, 700, 256, dt, False) for dt in (torch.bfloat16, torch.float32)]
    # bf16 at qwen3's dh 128 and the other group sizes: exact (1, 16) and padded (3, 12)
    cases += [(b, kv, gq, s, 128, torch.bfloat16, False) for b, kv, gq, s in
              [(2, 4, 1, 512), (3, 2, 3, 300), (2, 2, 12, 700), (2, 2, 16, 700)]]
    for b, kv, gq, s, dh, dt, timed in cases:
        chunk = chunk_positions(s, dh, torch.finfo(dt).bits // 8)
        lengths = ragged_lengths(b, s, rng, chunk)
        q = torch.randn((b, kv, gq, dh), generator=g, device=dev)
        k = torch.randn((b, kv, s, dh), generator=g, device=dev).to(dt)
        v = torch.randn((b, kv, s, dh), generator=g, device=dev).to(dt)
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = decode_attention_cuda(q, k, v, length)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, length)
        err = float((out - ref).abs().max())
        tag = f"B={b} KV={kv} GQ={gq} S={s} dh={dh} {names[dt]} chunk {chunk} ({-(-s // chunk)} chunks)"
        check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL), f"decode_attention {tag}: err {err}")
        max_err = max(max_err, err)
        for _ in range(2):
            check(torch.equal(decode_attention_cuda(q, k, v, length), out),
                  f"decode_attention {tag}: a repeated call differs")
        if b == 32:
            for r in (0, 1, 17, 31):
                solo = decode_attention_cuda(q[r:r + 1].contiguous(), k[r:r + 1], v[r:r + 1],
                                             length[r:r + 1])
                check(torch.equal(solo[0], out[r]),
                      f"decode_attention {tag}: row {r} alone differs from the same row in the batch")
        if not timed:
            print(f"[decode] {tag} lengths {lengths[:4]}: max_abs_err {err:.3g}", flush=True)
            continue
        big = b * s >= 8 * 32768
        wall, on_card, per_call = time_decode_calls(
            {"kernel": lambda: decode_attention_cuda(q, k, v, length),
             "plain": lambda: decode_attention_ref(q, k, v, length),
             "sdpa": lambda: sdpa_call(q, k, v, length)}, 3 if big else 10, tag)
        bound, by = decode_bound(lengths, s, kv, gq, dh, k.element_size())
        rows[(b, s, names[dt])] = dict(
            ms=wall["kernel"], plain_ms=wall["plain"], library_ms=wall["sdpa"],
            device_ms=on_card["kernel"], plain_device_ms=on_card["plain"],
            library_device_ms=on_card["sdpa"], launches_per_call=per_call, chunk=chunk,
            bound_ms=bound, bound_by=by, max_abs_err=err, lengths=lengths)
        print(f"[decode] {tag} positions {sum(lengths)}: kernel {wall['kernel']:.4f} ms "
              f"(device {on_card['kernel']:.4f}, {per_call:g} kernel per call), plain "
              f"{wall['plain']:.4f} ({on_card['plain']:.4f}), sdpa {wall['sdpa']:.4f} "
              f"({on_card['sdpa']:.4f}), bound {bound:.6g} ms ({by}); device / bound "
              f"{on_card['kernel'] / bound:.3f}, device / sdpa device "
              f"{on_card['kernel'] / on_card['sdpa']:.3f}; max_abs_err {err:.3g}", flush=True)
        if (b, s, dt) == (8, 2088, torch.bfloat16):
            for r, n in enumerate(lengths):     # the kernel never reads past a length
                k[r, :, n:], v[r, :, n:] = float("nan"), float("nan")
            again = decode_attention_cuda(q, k, v, length)
            torch.cuda.synchronize()
            check(torch.equal(again, out), "decode_attention read a position past a row's length")
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    print("[decode] every shape within rtol=atol=2e-4 of the plain version; repeated calls "
          "equal (bitwise); a row alone equals the row in a batch of 32 (bitwise); NaN past each "
          "length never reaches the output; one CUDA kernel per call", flush=True)
    return {"rows": rows, "max_abs_err": max_err}


# ----------------------------------------------------------------------
# phase 3c: the decode kernel's sliding window and softcap
# ----------------------------------------------------------------------
WINDOW_HEADS = {"gemma2": (4, 2, 256), "qwen3": (8, 5, 128)}   # (KV, GQ, dh)
WINDOW_S = 8192


def sdpa_window_call(q, k, v, length, window: int):
    """The library yardstick with a window: one scaled_dot_product_attention
    call whose boolean mask keeps length - window <= p < length (it reads
    every position; no single PyTorch call applies a softcap)."""
    import torch

    b, kv, gq, dh = q.shape
    pos = torch.arange(k.shape[2], device=q.device)[None, :]
    keep = (pos < length[:, None]) & (pos >= length[:, None] - window)
    return torch.nn.functional.scaled_dot_product_attention(
        q.reshape(b, kv * gq, 1, dh).to(k.dtype), k, v, attn_mask=keep[:, None, None, :],
        enable_gqa=True)


def window_lengths(b: int, s: int, window: int, chunk: int) -> list:
    """Ragged lengths below, at and above the window, and S."""
    if b == 1:
        return [s - 5]
    return [s, 1, window - 1, window, window + 1, window + chunk // 2 + 3, s // 2 + 7, s - 1]


def decode_window_checks() -> dict:
    """The kernel with a window (4096, and 100, no multiple of any chunk) and
    a softcap (0, 50) against its plain version at gemma2's and qwen3's
    heads, B in {1, 8}, S = 8192, bf16 and f32: equal within the band; NaN
    below len - window and from len on never reaches the output (it equals
    the clean call bitwise); repeated calls and a row alone equal the batch
    bitwise; calls with other windows between two equal calls on the one
    cached workspace change nothing (the counters were left at zero)."""
    import torch

    from repro_torch.kernels.decode_attention import chunk_positions, decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    names = {torch.bfloat16: "bf16", torch.float32: "f32"}
    rows, max_err, n_cases = {}, 0.0, 0
    for head, (kv, gq, dh) in WINDOW_HEADS.items():
        for dt in (torch.bfloat16, torch.float32):
            chunk = chunk_positions(WINDOW_S, dh, torch.finfo(dt).bits // 8)
            for b in (1, 8):
                # scores of std ~8, so a cap of 50 bends the largest
                q = 8.0 * torch.randn((b, kv, gq, dh), generator=g, device=dev)
                k = torch.randn((b, kv, WINDOW_S, dh), generator=g, device=dev).to(dt)
                v = torch.randn((b, kv, WINDOW_S, dh), generator=g, device=dev).to(dt)
                first = {}
                for window in (4096, 100):
                    lengths = window_lengths(b, WINDOW_S, window, chunk)
                    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
                    for cap in (0.0, 50.0):
                        tag = (f"{head} B={b} KV={kv} GQ={gq} S={WINDOW_S} dh={dh} {names[dt]} "
                               f"window {window} softcap {cap:g} (chunk {chunk})")
                        out = decode_attention_cuda(q, k, v, length, window, cap)
                        torch.cuda.synchronize()
                        ref = decode_attention_ref(q, k, v, length, window, cap)
                        err = float((out - ref).abs().max())
                        check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
                              f"decode_attention {tag}: err {err}")
                        max_err = max(max_err, err)
                        n_cases += 1
                        check(torch.equal(decode_attention_cuda(q, k, v, length, window, cap), out),
                              f"decode_attention {tag}: a repeated call differs")
                        first[(window, cap)] = (out, length)
                        if b == 8:
                            for r in (0, 2, 5):
                                solo = decode_attention_cuda(q[r:r + 1].contiguous(), k[r:r + 1],
                                                             v[r:r + 1], length[r:r + 1], window,
                                                             cap)
                                check(torch.equal(solo[0], out[r]),
                                      f"decode_attention {tag}: row {r} alone differs from "
                                      f"the row in the batch")
                        if b == 8 and dt == torch.bfloat16 and (window, cap) != (100, 50.0):
                            rows[(head, window, cap)] = window_timing(
                                q, k, v, length, lengths, window, cap, kv, gq, dh, tag, err)
                # both windows ran on this shape's one workspace: the first
                # call's results come back bitwise
                for (window, cap), (out, length) in first.items():
                    check(torch.equal(decode_attention_cuda(q, k, v, length, window, cap), out),
                          f"decode_attention {head} B={b} {names[dt]} window {window} softcap "
                          f"{cap:g}: differs after calls with other windows on its workspace")
                # NaN outside each row's window never reaches the output
                for (window, cap), (out, length) in first.items():
                    kn, vn = k.clone(), v.clone()
                    for r, n in enumerate(length.tolist()):
                        for t in (kn, vn):
                            t[r, :, :max(0, n - window)] = float("nan")
                            t[r, :, n:] = float("nan")
                    nan_out = decode_attention_cuda(q, kn, vn, length, window, cap)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(nan_out).all()) and torch.equal(nan_out, out),
                          f"decode_attention {head} B={b} {names[dt]} window {window} softcap "
                          f"{cap:g} read a position outside a row's window")
                    del kn, vn
                del q, k, v, first
                torch.cuda.empty_cache()
    print(f"[window] {n_cases} cases within rtol=atol=2e-4 of the plain version (max_abs_err "
          f"{max_err:.3g}); repeated calls, rows alone and calls after other windows on one "
          f"workspace equal (bitwise); NaN outside each row's window never reaches the output",
          flush=True)
    return {"rows": rows, "max_abs_err": max_err}


def window_timing(q, k, v, length, lengths, window, cap, kv, gq, dh, tag, err) -> dict:
    """Kernel, plain version and (without a softcap) SDPA with the window
    mask: CUDA-event ms and profiler device ms; the bound counts the bytes
    of min(len, window) positions a row."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref

    fns = {"kernel": lambda: decode_attention_cuda(q, k, v, length, window, cap),
           "plain": lambda: decode_attention_ref(q, k, v, length, window, cap)}
    if cap == 0:
        fns["sdpa"] = lambda: sdpa_window_call(q, k, v, length, window)
    wall, on_card, _ = time_decode_calls(fns, 10, tag)
    live = [min(int(n), window) for n in lengths]
    bound, by = decode_bound(live, k.shape[2], kv, gq, dh, k.element_size())
    lib = wall.get("sdpa")
    print(f"[window] {tag} positions read {sum(live)} of {sum(lengths)}: kernel "
          f"{wall['kernel']:.4f} ms (device {on_card['kernel']:.4f}), plain {wall['plain']:.4f} "
          f"({on_card['plain']:.4f}), sdpa " + (f"{lib:.4f} ({on_card['sdpa']:.4f})" if lib else
                                                 "none (no PyTorch call applies a softcap)") +
          f", bound {bound:.6g} ms ({by}); device / bound {on_card['kernel'] / bound:.3f}; "
          f"max_abs_err {err:.3g}", flush=True)
    return dict(ms=wall["kernel"], plain_ms=wall["plain"], library_ms=lib,
                device_ms=on_card["kernel"], plain_device_ms=on_card["plain"],
                library_device_ms=on_card.get("sdpa"), bound_ms=bound, bound_by=by,
                max_abs_err=err, lengths=lengths, positions=sum(live))


# ----------------------------------------------------------------------
# phase 3d: the decode kernel's int8 K/V
# ----------------------------------------------------------------------
# (name, KV, GQ, dh, S, windows, softcaps): qwen3-14b's serving shape,
# gemma2-2b's windowed one, hymba-1.5b's (a 1,024 window on 29 of its 32 layers)
INT8_SHAPES = (("qwen3", 8, 5, 128, 2088, (None,), (0.0,)),
               ("gemma2", 4, 2, 256, WINDOW_S, (4096,), (0.0, 50.0)),
               ("hymba", 5, 5, 64, 2088, (1024, None), (0.0,)))


def dequant_sdpa_call(q, k, v, ks, vs, length, window, dt):
    """The library yardstick for int8, timed here and used nowhere in the
    port: two PyTorch calls, the reference's int8 decode's own order --
    dequantize_kv of the whole cache (to the model's type), then one
    scaled_dot_product_attention with the length (and window) mask."""
    from repro_torch.models.layers import dequantize_kv

    kd, vd = dequantize_kv(k, ks).to(dt), dequantize_kv(v, vs).to(dt)
    if window is None:
        return sdpa_call(q, kd, vd, length)
    return sdpa_window_call(q, kd, vd, length, window)


def decode_int8_checks() -> dict:
    """The kernel's int8 K/V (with f32 scales) against its plain version at
    qwen3's, gemma2's and hymba's heads, B = 8, ragged lengths (a window
    start that is no multiple of 4 among them), dequantized to bf16 and to
    f32: within the band of phase 3b; NaN scales and garbage int8 outside
    each row's window never reach the output; a row alone equals the row
    in the batch and a repeated call the first, bitwise.  Device ms of the
    int8 kernel (bf16 dequant) beside the bf16 kernel's at the same shape,
    the plain version's, dequantize + SDPA's and the bound of (dh + 4)
    bytes a position, head and tensor."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import (chunk_positions, decode_attention_cuda,
                                                      tile_elem)
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.models.layers import quantize_kv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(5)
    rows, max_err, n_cases = {}, 0.0, 0
    t0 = time.perf_counter()
    for name, kv, gq, dh, s, windows, caps in INT8_SHAPES:
        b = 8
        chunk = chunk_positions(s, dh, tile_elem(torch.int8))
        q = 8.0 * torch.randn((b, kv, gq, dh), generator=g, device=dev)
        k32 = torch.randn((b, kv, s, dh), generator=g, device=dev)
        v32 = torch.randn((b, kv, s, dh), generator=g, device=dev)
        (k, ks), (v, vs) = quantize_kv(k32), quantize_kv(v32)
        kb, vb = k32.to(torch.bfloat16), v32.to(torch.bfloat16)
        del k32, v32
        for window in windows:
            if window is None:
                lengths = ragged_lengths(b, s, rng, chunk)
            else:
                lengths = window_lengths(b, s, window, chunk)
                check(any((n - window) % 4 for n in lengths if n > window),
                      f"int8 {name}: no window start off a multiple of 4")
            length = torch.tensor(lengths, dtype=torch.int32, device=dev)
            for cap in caps:
                for dq in (torch.bfloat16, torch.float32):
                    args = (q, k, v, length, window, cap, ks, vs, dq)
                    tag = (f"int8 {name} B={b} KV={kv} GQ={gq} S={s} dh={dh} window {window} "
                           f"softcap {cap:g} dequant {str(dq)[6:]} (chunk {chunk})")
                    out = decode_attention_cuda(*args)
                    torch.cuda.synchronize()
                    ref = decode_attention_ref(*args)
                    err = float((out - ref).abs().max())
                    check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
                          f"decode_attention {tag}: err {err}")
                    max_err = max(max_err, err)
                    n_cases += 1
                    check(torch.equal(decode_attention_cuda(*args), out),
                          f"decode_attention {tag}: a repeated call differs")
                    for r in (0, 2, 5):
                        solo = decode_attention_cuda(
                            q[r:r + 1].contiguous(), k[r:r + 1], v[r:r + 1], length[r:r + 1],
                            window, cap, ks[r:r + 1], vs[r:r + 1], dq)
                        check(torch.equal(solo[0], out[r]),
                              f"decode_attention {tag}: row {r} alone differs from the batch")
                    if dq == torch.float32:
                        continue
                    # outside each row's window: NaN scales, garbage int8
                    kn, vn, ksn, vsn = k.clone(), v.clone(), ks.clone(), vs.clone()
                    for r, n in enumerate(lengths):
                        lo = max(0, n - (window or s))
                        for t in (ksn, vsn):
                            t[r, :, :lo] = float("nan")
                            t[r, :, n:] = float("nan")
                        for t in (kn, vn):
                            t[r, :, :lo] = 127
                            t[r, :, n:] = -127
                    again = decode_attention_cuda(q, kn, vn, length, window, cap, ksn, vsn, dq)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(again).all()) and torch.equal(again, out),
                          f"decode_attention {tag} read a position or scale outside a row's window")
                    del kn, vn, ksn, vsn
                    rows[(name, window, cap)] = int8_timing(
                        q, k, v, ks, vs, kb, vb, length, lengths, window, cap, kv, gq, dh, tag,
                        err)
        del q, k, v, ks, vs, kb, vb
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"[int8] {n_cases} cases within rtol=atol=2e-4 of the plain version (max_abs_err "
          f"{max_err:.3g}); repeated calls and rows alone equal (bitwise); NaN scales and garbage "
          f"int8 outside each row's window never reach the output; phase 3d took {secs:.1f} s",
          flush=True)
    return {"rows": rows, "max_abs_err": max_err, "seconds": secs}


def int8_timing(q, k, v, ks, vs, kb, vb, length, lengths, window, cap, kv, gq, dh, tag,
                err) -> dict:
    """The int8 kernel (bf16 dequant), the bf16 kernel on the same values in
    bf16, the plain version and (without a softcap) dequantize + SDPA:
    CUDA-event ms and profiler device ms; the bound counts (dh + 4) bytes
    of K and of V per position below min(len, window) and kv head."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref

    bf = torch.bfloat16
    fns = {"kernel": lambda: decode_attention_cuda(q, k, v, length, window, cap, ks, vs, bf),
           "bf16": lambda: decode_attention_cuda(q, kb, vb, length, window, cap),
           "plain": lambda: decode_attention_ref(q, k, v, length, window, cap, ks, vs, bf)}
    if cap == 0:
        fns["library"] = lambda: dequant_sdpa_call(q, k, v, ks, vs, length, window, bf)
    wall, on_card, _ = time_decode_calls(fns, 10, tag)
    s = k.shape[2]
    live = [min(int(n), window or s) for n in lengths]
    bound, by = decode_bound(live, s, kv, gq, dh, 1, scale_bytes=4)
    bound16, _ = decode_bound(live, s, kv, gq, dh, 2)
    lib = wall.get("library")
    print(f"[int8] {tag} positions read {sum(live)}: int8 kernel {wall['kernel']:.4f} ms (device "
          f"{on_card['kernel']:.4f}), bf16 kernel {wall['bf16']:.4f} ({on_card['bf16']:.4f}), "
          f"plain {wall['plain']:.4f} ({on_card['plain']:.4f}), dequantize_kv + sdpa (two calls) "
          + (f"{lib:.4f} ({on_card['library']:.4f})" if lib else "none (no PyTorch call applies "
             "a softcap)") +
          f"; bound {bound:.6g} ms ({by}; bf16's {bound16:.6g}); int8 device / bound "
          f"{on_card['kernel'] / bound:.3f}, int8 / bf16 device "
          f"{on_card['kernel'] / on_card['bf16']:.3f}; max_abs_err {err:.3g}", flush=True)
    return dict(ms=wall["kernel"], plain_ms=wall["plain"], library_ms=lib,
                device_ms=on_card["kernel"], plain_device_ms=on_card["plain"],
                library_device_ms=on_card.get("library"), bf16_ms=wall["bf16"],
                bf16_device_ms=on_card["bf16"], bound_ms=bound, bound_by=by,
                bf16_bound_ms=bound16, max_abs_err=err, lengths=lengths, positions=sum(live))


# ----------------------------------------------------------------------
# phase 3f: the decode kernel at the encdec and vlm serving shapes
# ----------------------------------------------------------------------
SEAMLESS = "seamless-m4t-large-v2"
INTERNVL = "internvl2-76b"
# (tag, B, KV, GQ, S, dh, every row full): seamless's cross-attention over
# its 1,024 frames, its self-attention over a 128-position cache, and
# internvl2's self-attention over 256 patches + a 2,048-token prompt + 16
FRONTEND_SHAPES = (("seamless-cross", 8, 16, 1, 1024, 64, True),
                   ("seamless-self", 8, 16, 1, 128, 64, False),
                   ("internvl2-self", 8, 8, 8, 2320, 128, False))


def decode_frontend_checks() -> dict:
    """Phase 3f: the bf16 decode kernel against its plain version at the
    shapes phases 12 and 12b give it (GQ 1 at dh 64, and a cache whose rows
    are all full, had not run before): repeated calls bitwise equal, one
    CUDA kernel a call; kernel, plain and SDPA times beside the bound."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import chunk_positions, decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(6)
    rows, max_err = {}, 0.0
    for tag, b, kv, gq, s, dh, full in FRONTEND_SHAPES:
        chunk = chunk_positions(s, dh, 2)
        lengths = [s] * b if full else ragged_lengths(b, s, rng, chunk)
        q = torch.randn((b, kv, gq, dh), generator=g, device=dev)
        k = torch.randn((b, kv, s, dh), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((b, kv, s, dh), generator=g, device=dev).to(torch.bfloat16)
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = decode_attention_cuda(q, k, v, length)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, length)
        err = float((out - ref).abs().max())
        what = f"{tag}: B={b} KV={kv} GQ={gq} S={s} dh={dh} bf16 chunk {chunk}"
        check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL), f"decode_attention {what}: err {err}")
        check(torch.equal(decode_attention_cuda(q, k, v, length), out),
              f"decode_attention {what}: a repeated call differs")
        max_err = max(max_err, err)
        wall, on_card, per_call = time_decode_calls(
            {"kernel": lambda: decode_attention_cuda(q, k, v, length),
             "plain": lambda: decode_attention_ref(q, k, v, length),
             "sdpa": lambda: sdpa_call(q, k, v, length)}, 10, what)
        bound, by = decode_bound(lengths, s, kv, gq, dh, 2)
        rows[tag] = dict(ms=wall["kernel"], device_ms=on_card["kernel"], plain_ms=wall["plain"],
                         plain_device_ms=on_card["plain"], library_ms=wall["sdpa"],
                         library_device_ms=on_card["sdpa"], bound_ms=bound, bound_by=by,
                         max_abs_err=err, shape={"B": b, "KV": kv, "GQ": gq, "S": s, "dh": dh,
                                                 "kv_dtype": "bf16",
                                                 "positions": sum(lengths)})
        print(f"[decode-frontend] {what}, lengths {lengths[:4]}: kernel {wall['kernel']:.4f} ms "
              f"(device {on_card['kernel']:.4f}), plain {wall['plain']:.4f} "
              f"({on_card['plain']:.4f}), sdpa {wall['sdpa']:.4f} ({on_card['sdpa']:.4f}), bound "
              f"{bound:.6g} ms ({by}); device / bound {on_card['kernel'] / bound:.3f}; "
              f"max_abs_err {err:.3g}", flush=True)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"[decode-frontend] every shape within rtol=atol=2e-4 of the plain version, repeated "
          f"calls equal, one CUDA kernel a call; phase 3f took {secs:.1f} s", flush=True)
    return {"rows": rows, "max_abs_err": max_err}


# phase 3f, split rows: one rank's KV heads of a cache held whole
# ----------------------------------------------------------------------
# phase 13b's attention: gemma2-2b's 4 KV heads (GQ 2, dh 256) cut over a
# model axis of 2, each rank's 2 read in place from the whole cache
# (B, cache KV, KV a rank, GQ, S, dh, window)
SPLIT_SHAPE = (4, 4, 2, 2, WINDOW_S, 256, 4096)


def decode_split_checks() -> dict:
    """Phase 3f's split rows: the kernel over one rank's KV heads (kv0 = 0
    and 2, two of a cache's four) at gemma2-2b's split shape, bf16 and
    int8 (bf16 dequant), window 4096, softcap 0 and 50, ragged lengths
    below and above the window, against its plain version on the same
    heads: within the band of phase 3b; bitwise the heads kv0 .. kv0 + 1
    of the whole-cache launch; NaN in every other head never reaches the
    output (the slice is read in place, nothing else).  The split launch's
    ms (events and profiler device time) beside the whole-cache launch's,
    the plain version's, the library's (SDPA with the window mask over the
    slice; int8: dequantize_kv of the slice + SDPA; none with a softcap)
    and the bound of the rank's bytes."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import (chunk_positions, decode_attention_cuda,
                                                      tile_elem)
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.models.layers import quantize_kv

    t0 = time.perf_counter()
    b, kvc, kvl, gq, s, dh, window = SPLIT_SHAPE
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    chunk = chunk_positions(s, dh, 2)
    lengths = [s, 1, window + 1, window + chunk // 2 + 3]           # below, past the window
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q_all = torch.randn((b, kvc, gq, dh), generator=g, device=dev)
    k32 = torch.randn((b, kvc, s, dh), generator=g, device=dev)
    v32 = torch.randn((b, kvc, s, dh), generator=g, device=dev)
    (k8, ks), (v8, vs) = quantize_kv(k32), quantize_kv(v32)
    caches = {"bf16": (k32.to(torch.bfloat16), v32.to(torch.bfloat16), {}),
              "int8": (k8, v8, dict(k_scale=ks, v_scale=vs, dequant_dtype=torch.bfloat16))}
    del k32, v32
    live = [min(int(n), window) for n in lengths]
    rows, max_err = {}, 0.0
    for name, (k, v, extra) in caches.items():
        elem, scale_bytes = (1, 4) if name == "int8" else (2, 0)
        check(chunk == chunk_positions(s, dh, tile_elem(k.dtype)), "split: chunk rule")
        for cap in (0.0, 50.0):
            whole = decode_attention_cuda(q_all, k, v, length, window, cap, **extra)
            for kv0 in (0, kvc - kvl):
                q = q_all[:, kv0:kv0 + kvl].contiguous()
                tag = (f"split {name} B={b} cache KV={kvc} kv0={kv0} KV={kvl} GQ={gq} S={s} "
                       f"dh={dh} window {window} softcap {cap:g} (chunk {chunk})")
                out = decode_attention_cuda(q, k, v, length, window, cap, kv0=kv0, **extra)
                torch.cuda.synchronize()
                ref = decode_attention_ref(q, k, v, length, window, cap, kv0=kv0, **extra)
                err = float((out - ref).abs().max())
                check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
                      f"decode_attention {tag}: err {err}")
                check(torch.equal(out, whole[:, kv0:kv0 + kvl]),
                      f"decode_attention {tag}: differs from the whole-cache launch's heads")
                max_err = max(max_err, err)
                # every head outside the slice poisoned: the slice is all it reads
                kn, vn = k.clone(), v.clone()
                other = [h for h in range(kvc) if not kv0 <= h < kv0 + kvl]
                poison = dict(extra)
                if name == "int8":
                    poison["k_scale"], poison["v_scale"] = ks.clone(), vs.clone()
                    for t in (poison["k_scale"], poison["v_scale"]):
                        t[:, other] = float("nan")
                else:
                    for t in (kn, vn):
                        t[:, other] = float("nan")
                again = decode_attention_cuda(q, kn, vn, length, window, cap, kv0=kv0, **poison)
                torch.cuda.synchronize()
                check(torch.equal(again, out), f"decode_attention {tag} read another head")
                del kn, vn, poison
                if kv0 == 0:
                    continue
                sl = slice(kv0, kv0 + kvl)
                fns = {"kernel": lambda: decode_attention_cuda(q, k, v, length, window, cap,
                                                               kv0=kv0, **extra),
                       "whole": lambda: decode_attention_cuda(q_all, k, v, length, window, cap,
                                                              **extra),
                       "plain": lambda: decode_attention_ref(q, k, v, length, window, cap,
                                                             kv0=kv0, **extra)}
                if cap == 0 and name == "bf16":
                    fns["library"] = lambda: sdpa_window_call(q, k[:, sl], v[:, sl], length,
                                                              window)
                elif cap == 0:
                    fns["library"] = lambda: dequant_sdpa_call(
                        q, k[:, sl], v[:, sl], ks[:, sl], vs[:, sl], length, window,
                        torch.bfloat16)
                wall = {n: cuda_ms(f, 20 if n in ("kernel", "whole") else 10)
                        for n, f in fns.items()}
                on_card = {n: device_ms(fns[n], 10, expect=1) for n in ("kernel", "whole")}
                check(all(d[1] == 1 for d in on_card.values()),
                      f"decode_attention {tag}: not one CUDA kernel a call: {on_card}")
                bound, by = decode_bound(live, s, kvl, gq, dh, elem, scale_bytes)
                whole_bound, _ = decode_bound(live, s, kvc, gq, dh, elem, scale_bytes)
                lib = wall.get("library")
                rows[(name, cap)] = dict(
                    ms=wall["kernel"], device_ms=on_card["kernel"][0], whole_ms=wall["whole"],
                    whole_device_ms=on_card["whole"][0], plain_ms=wall["plain"],
                    library_ms=lib, bound_ms=bound, bound_by=by, whole_bound_ms=whole_bound,
                    max_abs_err=err, positions=sum(live))
                print(f"[decode-split] {tag}, lengths {lengths}: kernel {wall['kernel']:.4f} ms "
                      f"(device {on_card['kernel'][0]:.4f}) over the rank's heads, whole-cache "
                      f"launch {wall['whole']:.4f} ({on_card['whole'][0]:.4f}), plain "
                      f"{wall['plain']:.4f}, library "
                      + (f"{lib:.4f}" if lib is not None else "none (no PyTorch call applies "
                         "a softcap)")
                      + f"; bound of the rank's bytes {bound:.6g} ms ({by}; the whole cache's "
                      f"{whole_bound:.6g}); device / bound {on_card['kernel'][0] / bound:.3f}; "
                      f"max_abs_err {err:.3g}", flush=True)
    del caches, k8, v8, ks, vs, q_all
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"[decode-split] kv0 0 and {kvc - kvl} of {kvc} heads, bf16 and int8, softcap 0 and "
          f"50: within rtol=atol=2e-4 of the plain version (max_abs_err {max_err:.3g}), bitwise "
          f"the whole-cache launch's heads, no other head read; split rows took {secs:.1f} s",
          flush=True)
    return {"rows": rows, "max_abs_err": max_err, "seconds": secs}


# ----------------------------------------------------------------------
# phases 6, 6b, 6c: LM serving at full width and depth
# ----------------------------------------------------------------------
GEMMA = "gemma2-2b"
OLMOE = "olmoe-1b-7b"
HYMBA = "hymba-1.5b"
XLSTM = "xlstm-1.3b"
# phases 6d and 6e: two batches of 8 equal-length prompts (a recurrent
# family is served equal-length), the second past hymba's 1,024 window
RECURRENT_PROMPTS = [1536] * 8 + [2048] * 8


def state_bytes(cfg, b: int) -> int:
    """Bytes of a batch of b rows' recurrent decode state (fp32): a hybrid
    model's Mamba h and conv prefix per layer; an xLSTM's sLSTM c, n, h, m
    per group and mLSTM C, n, m per mLSTM block."""
    if cfg.family == "hybrid":
        return 4 * cfg.n_layers * b * cfg.d_model * (cfg.ssm_state + cfg.ssm_conv - 1)
    if cfg.family == "ssm":
        g = cfg.n_layers // cfg.slstm_every
        h, dh = cfg.n_heads, cfg.dh
        return 4 * b * h * (g * 4 * dh + g * (cfg.slstm_every - 1) * (dh * dh + dh + 1))
    return 0


def decode_step_bounds(model, step_lengths) -> dict:
    """The least time of one decode step, in ms at 3.35 TB/s, for a step
    whose rows attend to ``step_lengths`` positions (a vlm model's count
    its prefix): every weight the step reads once (the embedding only as a
    tied head; a gathered row is nothing; an encdec model's encoder and its
    layers' ``xattn.wk``/``wv`` not at all, the cross cache having been
    made at prefill) plus each layer's K/V below min(length, window) a row
    (int8: dh + 4 bytes a position, head and tensor) plus an encdec model's
    cross K/V once a layer (``cross_bytes``) plus a recurrent model's
    state, read and written once.  For MoE, ``weights`` counts every expert
    (what the dense (B, E, C, D) dispatch reads) and ``active`` only the
    top-k experts of one token."""
    cfg = model.cfg
    unread = ("enc_", "xattn.wk", "xattn.wv")
    w_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                  if not (n.startswith(unread[0]) or n.endswith(unread[1:])))
    elem = model.embed.element_size()
    read = w_bytes - (0 if cfg.tie_embeddings else model.embed.numel() * elem)
    per_pos = cfg.dh + 4 if cfg.kv_cache_int8 else cfg.dh * elem
    kv = sum(min(int(n), w) for w in model.windows for n in step_lengths) * \
        cfg.n_kv_heads * per_pos * 2
    cross = (2 * cfg.n_layers * len(step_lengths) * cfg.frontend_len * cfg.n_kv_heads * cfg.dh
             * elem if cfg.is_encdec else 0)
    state = 2 * state_bytes(cfg, len(step_lengths))
    out = {"weights": 1e3 * (read + kv + cross + state) / H100_BYTES_PER_S, "kv_bytes": kv,
           "read_bytes": read, "state_bytes": state, "cross_bytes": cross}
    if cfg.is_moe:
        idle = cfg.n_layers * (cfg.n_experts - cfg.top_k_experts) * 3 * cfg.d_model * cfg.d_ff
        out["active"] = 1e3 * (read - idle * elem + kv) / H100_BYTES_PER_S
    return out


def check_encdec_bound(rows: int = 8, fill: int = 64) -> dict:
    """Before the script's first use of the card: ``decode_step_bounds`` of
    seamless-m4t-large-v2 (a fake bf16 model, nothing allocated) at
    ``rows`` rows of ``fill`` positions equals a count from the config
    alone: per decoder layer ln1, ln_x, ln2, attn's wq, wk, wv, wo,
    xattn's wq and wo, the MLP; final_ln and lm_head; the self K/V and the
    cross K/V (rows x F positions) of every layer; bf16."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(SEAMLESS)
    d, hd, kvd = cfg.d_model, cfg.n_heads * cfg.dh, cfg.n_kv_heads * cfg.dh
    layer = 3 * d + (d * hd + 2 * d * kvd + hd * d) + (d * hd + hd * d) + 3 * d * cfg.d_ff
    weights = 2 * (cfg.n_layers * layer + d + d * cfg.vocab_size)
    self_kv = 2 * cfg.n_layers * rows * fill * kvd * 2
    cross_kv = 2 * cfg.n_layers * rows * cfg.frontend_len * kvd * 2
    with FakeTensorMode():
        b = decode_step_bounds(Model(cfg, device="cpu"), [fill] * rows)
    got = b["read_bytes"] + b["kv_bytes"] + b["cross_bytes"]
    hand = weights + self_kv + cross_kv
    check(got == hand, f"decode_step_bounds of {SEAMLESS} counts {got} bytes, the hand count "
                       f"{hand}")
    print(f"[bounds] {SEAMLESS} decode step at {rows} rows x {fill} positions: "
          f"decode_step_bounds {got / 1e9:.4f} GB = the hand count (decoder weights and head "
          f"{weights / 1e9:.4f} GB, self K/V {self_kv / 1e9:.4f}, cross K/V read by "
          f"{cfg.n_layers} layers {cross_kv / 1e9:.4f}; the encoder and xattn.wk/wv unread), "
          f"{b['weights']:.4f} ms at 3.35 TB/s", flush=True)
    return b


def cache_bytes(cfg, slots: int, max_len: int, elem: int) -> int:
    """The KV cache's bytes (int8: plus its fp32 scales)."""
    if cfg.family == "ssm":
        return 0
    n = 2 * cfg.n_layers * slots * cfg.n_kv_heads * max_len
    return n * cfg.dh + 4 * n if cfg.kv_cache_int8 else n * cfg.dh * elem


def probe_layers(model) -> list:
    """The layers the kernel is held to its plain version on: the first
    with a window and the first with full attention (one of them if all
    layers are alike)."""
    from repro_torch.models.model import GLOBAL_WINDOW

    ws = model.windows
    local = [i for i, w in enumerate(ws) if w < GLOBAL_WINDOW]
    full = [i for i, w in enumerate(ws) if w >= GLOBAL_WINDOW]
    return sorted({*local[:1], *full[:1]}) if local and full else [0, len(ws) - 1]


def lm_serving(arch: str = QWEN, plens=(256, 2048), n_requests: int = 16, slots: int = 8,
               new: int = 32, max_len: int = 2088, tag: str = "lm", n_layers=None,
               prompt_lens=None, n_serve=None, teacher_forced: bool = True,
               idle_steps: int = 8, **overrides) -> dict:
    """One architecture through ServeEngine at full width: prompts of
    ``prompt_lens`` tokens (one per request) or uniform on ``plens``
    (seeded), the first ``n_serve`` of them served (all by default), and
    ``idle_steps`` decode steps profiled for the idle share.  ``overrides``
    replace config fields (``kv_cache_int8=True``)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.models import Model, layers
    from repro_torch.models.layers import attn_qkv, rms_norm
    from repro_torch.serve import Request, ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if n_layers is not None:
        overrides["n_layers"] = n_layers
    cfg = dataclasses.replace(cfg, **overrides)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_alloc = torch.cuda.memory_allocated() - base
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    kv_cache = cache_bytes(cfg, slots, max_len, model.embed.element_size())
    state = state_bytes(cfg, slots)
    print(f"[{tag}] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}{', int8 KV cache' if cfg.kv_cache_int8 else ''}; {w_bytes / 1e9:.3f} GB of "
          f"weights initialised on the card in {init_s:.2f} s; KV cache {kv_cache / 1e9:.3f} GB "
          f"({slots} slots x {max_len}); recurrent state {state / 1e9:.3f} GB", flush=True)

    rng = np.random.default_rng(0)
    if prompt_lens is None:
        prompt_lens = rng.integers(plens[0], plens[1] + 1, n_requests)
    prompt_lens = np.asarray(prompt_lens)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new_tokens=new) for i, n in enumerate(prompt_lens)]
    reqs = reqs[:n_serve]
    plens = prompt_lens[:len(reqs)]
    n_requests = len(reqs)
    eng = ServeEngine(model, batch_slots=slots, max_len=max_len)
    prefill, decode = eng._prefill, eng._decode
    prefill_s, step_ms, step_lengths, last, dropped, cache_nbytes = [], [], [], {}, [], []

    def timed_prefill(batch, lens):
        torch.cuda.synchronize()
        n_log = len(layers.moe_drop_log) if layers.moe_drop_log is not None else 0
        t = time.perf_counter()
        out = prefill(batch, lens)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t)
        cache_nbytes.append(sum(x.nbytes for x in _leaves(out[1])))
        if layers.moe_drop_log is not None:
            dropped.append(int(sum(int(x) for x in layers.moe_drop_log[n_log:])))
        last.update(cache=out[1], lens=lens, tokens=batch["tokens"])
        return out

    def timed_decode(cache, tok, lens):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(cache, tok, lens)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        step_lengths.append((lens + 1).tolist())
        return out

    eng._prefill, eng._decode = timed_prefill, timed_decode
    if cfg.is_moe:
        layers.moe_drop_log = []
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    t0 = time.perf_counter()
    try:
        results = eng.run(reqs)
    finally:
        layers.moe_drop_log = None
    serve_s = time.perf_counter() - t0
    launches = ops.kernel_launches()
    n_steps = len(step_ms)
    n_attn = len(model.windows)          # attention layers: 0 in an xLSTM
    check(launches["decode_attention"] == n_attn * n_steps,
          f"{arch}: decode_attention launched {launches['decode_attention']} times over "
          f"{n_steps} decode steps of {n_attn} attention layers")
    check(all(len(results[r.uid]) == new and all(0 <= t < cfg.vocab_size for t in results[r.uid])
              for r in reqs), f"{arch}: a request came back without its tokens")
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_tok = sum(len(v) for v in results.values())
    med = float(np.median(step_ms))
    mid = step_lengths[int(np.argsort(step_ms)[len(step_ms) // 2])]   # the median step's rows
    bounds = decode_step_bounds(model, mid)
    bound = bounds["weights"]
    print(f"[{tag}] served {len(reqs)} requests ({n_tok} tokens; prompts {int(plens.min())}-"
          f"{int(plens.max())}) in {slots} slots in {serve_s:.2f} s: {n_tok / serve_s:.1f} tokens/s "
          f"end to end", flush=True)
    print(f"[{tag}] prefill per batch of {slots}: " + ", ".join(f"{x:.3f} s" for x in prefill_s),
          flush=True)
    if cfg.is_moe:
        print(f"[{tag}] (token, expert) assignments dropped per prefill batch (capacity factor "
              f"{cfg.capacity_factor}): {dropped} of " + ", ".join(
                  str(slots * int(max(plens[i:i + slots])) * cfg.top_k_experts * cfg.n_layers)
                  for i in range(0, n_requests, slots)), flush=True)
    extra = (f"; {bounds['active']:.3f} ms counting the {cfg.top_k_experts} active experts of a "
             f"token, step / that bound {med / bounds['active']:.3f}") if cfg.is_moe else ""
    print(f"[{tag}] decode: {n_steps} steps, median {med:.3f} ms/step (p90 "
          f"{np.percentile(step_ms, 90):.3f}), {slots / med * 1e3:.1f} tokens/s in decode; bound "
          f"{bound:.3f} ms/step (weights read {bounds['read_bytes'] / 1e9:.3f} GB + KV "
          f"{bounds['kv_bytes'] / 1e9:.3f} GB + state read and written "
          f"{bounds['state_bytes'] / 1e9:.3f} GB at 3.35 TB/s), step / bound {med / bound:.3f}"
          + extra, flush=True)
    print(f"[{tag}] decode_attention launches {launches['decode_attention']} = {n_attn} x "
          f"{n_steps} steps; peak memory {peak:.2f} GB", flush=True)

    # the kernel against its plain version on the model's own cache, at a
    # local and a global layer, and its device time per call there
    cache, lens, toks = last["cache"], last["lens"], last["tokens"]
    cache_err, layer_ms, per_step_ms = 0.0, {}, None
    if n_attn:
        rows = torch.arange(toks.shape[0], device=toks.device)
        x = model._embed(toks[rows, lens.long() - 1][:, None])
        for layer in probe_layers(model):
            lp, w = model.layers[layer], model.windows[layer]
            q = attn_qkv(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps), cfg, lens.long()[:, None])[0]
            q = q[:, 0].float().contiguous()
            kc, vc = cache["k"][layer], cache["v"][layer]
            sc = ((cache["k_scale"][layer], cache["v_scale"][layer], model.dtype)
                  if cfg.kv_cache_int8 else ())
            length = lens.to(torch.int32)
            out = decode_attention_cuda(q, kc, vc, length, w, cfg.attn_softcap, *sc)
            ref = decode_attention_ref(q, kc, vc, lens, w, cfg.attn_softcap, *sc)
            err = float((out - ref).abs().max())
            check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
                  f"{arch}: decode_attention on the model's cache, layer {layer}: err {err}")
            cache_err = max(cache_err, err)
            layer_ms[layer] = device_ms(
                lambda: decode_attention_cuda(q, kc, vc, length, w, cfg.attn_softcap, *sc), 10,
                expect=1)[0]
        n_local = sum(w < max_len for w in model.windows)
        if len(layer_ms) == 2 and 0 < n_local < n_attn:
            lo_l = min(layer_ms, key=lambda i: model.windows[i])
            hi_l = max(layer_ms, key=lambda i: model.windows[i])
            lo_ms, hi_ms = layer_ms[lo_l], layer_ms[hi_l]
            per_step_ms = n_local * lo_ms + (n_attn - n_local) * hi_ms
            per_step = (f"{n_local} local x {lo_ms:.4f} (layer {lo_l}) + {n_attn - n_local} global "
                        f"x {hi_ms:.4f} (layer {hi_l}) = {per_step_ms:.4f} ms; local / global "
                        f"{lo_ms / hi_ms:.3f} against window / mean length "
                        f"{cfg.sliding_window / float(lens.float().mean()):.3f}")
        else:
            per_step_ms = n_attn * sum(layer_ms.values()) / len(layer_ms)
            per_step = f"{n_attn} x {per_step_ms / n_attn:.4f} = {per_step_ms:.4f} ms"
        print(f"[{tag}] kernel vs plain on the model's cache after prefill (layers "
              f"{sorted(layer_ms)}, lengths {lens.tolist()}): max_abs_err {cache_err:.3g}; device "
              f"ms per call " + ", ".join(f"{v:.4f} (layer {k})" for k, v in layer_ms.items()) +
              f"; per step about {per_step}", flush=True)
    last.clear()
    del cache

    agree = None
    if teacher_forced:
        agree = 0
        for r in reqs:
            out = np.asarray(results[r.uid])
            seq = np.concatenate([r.prompt, out[:-1].astype(np.int32)])
            h, _ = model._hidden({"tokens": seq[None]})
            # logits only from the last prompt position on (a whole 8,000-token
            # row of 256,000 fp32 logits would be 8.2 GB)
            tf = model._logits(h[:, len(r.prompt) - 1:])[0].argmax(-1).cpu().numpy()
            agree += int((tf == out).sum())
            del h
        agree /= n_tok
        print(f"[{tag}] served tokens equal to the teacher-forced argmax: {agree:.4f} of {n_tok} "
              f"(bf16, not gated: prefill and decode round at other places)", flush=True)
    idle, attn_ms, kernels = decode_idle_share(model, reqs[:slots], max_len, med, n=idle_steps,
                                               tag=tag)
    secs = time.perf_counter() - t_phase
    print(f"[{tag}] phase took {secs:.1f} s", flush=True)
    return {"model": model, "launches": launches, "step_ms": med, "bound_ms": bound,
            "bounds": bounds, "attention_ms_per_step": attn_ms, "layer_ms": layer_ms,
            "attention_ms_per_step_est": per_step_ms, "tokens_per_s": n_tok / serve_s,
            "prefill_s": prefill_s, "peak_gb": peak, "idle_share": idle, "cache_err": cache_err,
            "dropped": dropped, "agree": agree, "results": results, "kv_cache_bytes": kv_cache,
            "kernels_per_step": kernels, "seconds": secs, "init_alloc": init_alloc,
            "cache_nbytes": cache_nbytes}


def _leaves(tree):
    """The tensors of a (nested) cache dict."""
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def decode_idle_share(model, reqs, max_len: int, step_ms: float, n: int = 8,
                      tag: str = "lm") -> tuple:
    """Device busy time of n decode steps under torch.profiler, as
    ServeEngine runs them (argmax copied to the host each step), against
    the un-profiled median step wall time.  Returns (idle share,
    decode_attention ms a step, CUDA kernels a step)."""
    import numpy as np
    import torch

    plens = np.array([len(r.prompt) for r in reqs], np.int32)
    toks = np.zeros((len(reqs), int(plens.max())), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :plens[i]] = r.prompt
    lens = torch.as_tensor(plens, device=model.device)
    logits, cache = model.prefill({"tokens": toks}, max_len, lengths=lens)
    state = {"tok": torch.argmax(logits, -1).to(torch.int32), "lens": lens}

    def step():
        logits, _ = model.decode_step(cache, state["tok"], state["lens"])
        state["lens"], state["tok"] = state["lens"] + 1, torch.argmax(logits, -1).to(torch.int32)
        return state["tok"].cpu()

    for _ in range(2):
        step()
    return profile_steps(step, n, step_ms, tag)


def profile_steps(step, n: int, step_ms: float, tag: str) -> tuple:
    """n calls of ``step`` (one decode step, ending in a copy to the host)
    under torch.profiler: (idle share against the un-profiled median
    ``step_ms``, decode_attention ms a step, CUDA kernels a step), printed
    with the device busy time and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ka) / 1e3 / n
    if busy <= 0:
        print(f"[{tag}] decode step device time not measured (profiler saw none)", flush=True)
        return float("nan"), float("nan"), float("nan")
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:5]
    attn = sum(e.self_device_time_total for e in ka if "decode_attention" in e.key) / 1e3 / n
    per_step = sum(e.count for e in ka) / n
    idle = 1.0 - busy / step_ms
    print(f"[{tag}] decode step under torch.profiler: device busy {busy:.3f} ms/step against the "
          f"un-profiled {step_ms:.3f} ms/step (device idle share {idle:.3f}; profiled wall "
          f"{wall:.3f} ms/step; {per_step:.0f} CUDA kernels a step); decode_attention kernel "
          f"{attn:.4f} ms/step; top: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3 / n:.3f} ms" for e in top), flush=True)
    return idle, attn, per_step


# ----------------------------------------------------------------------
# phase 7: RAG over the phase-6 model and the phase-4 engine
# ----------------------------------------------------------------------
def rag_phase(model, mp: dict, k: int = 10) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import Predicate, RangePred
    from repro_torch.index.flat import l2_topk
    from repro_torch.kernels import ops
    from repro_torch.serve import RetrievalAugmentedServer

    eng, ds, preds, served = mp["engine"], mp["ds"], mp["preds"], mp["served"]
    rag = RetrievalAugmentedServer(model, eng,
                                   generator=torch.Generator(device="cuda").manual_seed(1))
    tokens = np.random.default_rng(2).integers(0, model.cfg.vocab_size, (8, 512)).astype(np.int32)
    # examples/rag_serve.py's range predicate, and gen_queries predicates
    # whose phase-4 plans were exact and approximate
    year_lo = float(np.quantile(ds.num[:, 0], 0.6))
    chosen = [("range year >= q0.6",
               Predicate(ranges=(RangePred(0, ((year_lo, float(ds.num[:, 0].max()) + 1),)),)))]
    exact = [i for i, r in enumerate(served) if r.plan.strategy in ("pre", "ipre")][:3]
    approx = [i for i, r in enumerate(served) if r.plan.strategy == "post"][:2]
    chosen += [(f"gen_queries[{i}]", preds[i]) for i in exact + approx]
    q_host = rag.embed(tokens) * rag.scale        # what retrieve queries with

    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    runs, embed_ms, ann_ms = [], [], []
    for name, pred in chosen:
        runs.append((name, pred, rag.retrieve(tokens, pred, k)))
        embed_ms.append(rag.last_timing["embed_s"] * 1e3 / len(tokens))
        ann_ms.append(rag.last_timing["ann_s"] * 1e3 / len(tokens))
    launches = ops.kernel_launches()
    check(launches["masked_l2_topk"] > 0, "RAG retrieval launched masked_l2_topk no time")

    vd = eng.vectors_dev
    n_exact = 0
    for j, (name, pred, outs) in enumerate(runs):
        mask = pred.eval(ds.cat, ds.num)
        for i, out in enumerate(outs):
            ids = out.result.ids[0][out.result.ids[0] >= 0]
            check(ids.size > 0 and bool(mask[ids].all()),
                  f"RAG {name} prompt {i}: an id fails the predicate, or none came back")
            if out.plan.strategy in ("pre", "ipre"):
                n_exact += 1
                td, ti = l2_topk(torch.as_tensor(q_host[i:i + 1], device=vd.device), vd, k,
                                 torch.as_tensor(mask, device=vd.device))
                check(same_up_to_ties(q_host[i], out.result.ids, out.result.dists,
                                      ti.cpu().numpy(), td.cpu().numpy()),
                      f"RAG {name} prompt {i}: exact plan differs from ground truth")
        print(f"[rag] {name}: plans " + ", ".join(sorted({o.plan.strategy for o in outs})) +
              f"; embed {embed_ms[j]:.3f} ms, ANN {ann_ms[j]:.3f} ms per request", flush=True)
    print(f"[rag] {len(runs)} predicates x {len(tokens)} prompts of {tokens.shape[1]} tokens: "
          f"median embed {np.median(embed_ms):.3f} ms/request, median ANN "
          f"{np.median(ann_ms):.3f} ms/request; every id passes its predicate; {n_exact} exact "
          f"plans equal ground truth up to ties; launches {launches}", flush=True)
    return {"launches": launches, "embed_ms": float(np.median(embed_ms)),
            "ann_ms": float(np.median(ann_ms))}


def int8_report(bf16: dict, int8: dict) -> None:
    """Phase 6f beside 6b: gemma2-2b's decode step and its kernel per step
    with the int8 cache and with bf16 (the profiler's, over decode steps of
    the same first 8 requests in both), the caches' bytes, and the share of
    6f's tokens equal to 6b's for the same requests (not gated)."""
    same = total = 0
    for uid, toks in int8["results"].items():
        ref = bf16["results"][uid][:len(toks)]
        same += sum(int(a == b) for a, b in zip(toks, ref))
        total += len(toks)
    int8["agree_bf16"] = same / total
    print(f"[gemma2-int8] decode {int8['step_ms']:.3f} ms/step (bound {int8['bound_ms']:.3f}) "
          f"against bf16's {bf16['step_ms']:.3f} (bound {bf16['bound_ms']:.3f}); decode_attention "
          f"{int8['attention_ms_per_step']:.4f} ms/step against bf16's "
          f"{bf16['attention_ms_per_step']:.4f} (torch.profiler, the first 8 requests' steps in "
          f"both; int8 / bf16 {int8['attention_ms_per_step'] / bf16['attention_ms_per_step']:.3f}); "
          f"KV cache "
          f"{int8['kv_cache_bytes'] / 1e9:.3f} GB with scales against "
          f"{bf16['kv_cache_bytes'] / 1e9:.3f} GB; tokens equal to 6b's for the same 8 requests: "
          f"{same}/{total} = {same / total:.4f} (not gated)", flush=True)


# ----------------------------------------------------------------------
# phases 8, 8b: fp32 exactness at full width, depth 4
# ----------------------------------------------------------------------
def fp32_exactness(arch: str = QWEN, n_layers: int = 4, new: int = 16, plens=(64, 512),
                   tag: str = "fp32", equal_len=None, teacher_forced: bool = True,
                   **overrides) -> dict:
    """Full width, ``n_layers`` deep, fp32: 4 requests (ragged on ``plens``,
    or all of ``equal_len`` tokens, as a recurrent family is served) in one
    batch give each the tokens it gets alone; with ``teacher_forced`` the
    served tokens equal the argmax of one teacher-forced forward over
    prompt + output, but where its top-2 gap is below 1e-4 x max|logit|."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeEngine

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32", **overrides)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(3)
    lens = [equal_len] * 4 if equal_len else rng.integers(plens[0], plens[1] + 1, 4)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lens]
    max_len = max(len(p) for p in prompts) + new
    batch = ServeEngine(model, batch_slots=4, max_len=max_len).run(
        [Request(uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        solo = ServeEngine(model, batch_slots=1, max_len=max_len).run(
            [Request(uid=0, prompt=p, max_new_tokens=new)])[0]
        check(solo == batch[i], f"{arch} fp32: prompt {i} ({len(p)} tokens) served alone gives "
                                f"{solo}, in the batch {batch[i]}")
    near = 0
    for i, p in enumerate(prompts if teacher_forced else []):
        out = np.asarray(batch[i])
        h, _ = model._hidden({"tokens": np.concatenate([p, out[:-1].astype(np.int32)])[None]})
        logits = model._logits(h[:, len(p) - 1:])[0]
        top2 = logits.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        scale = logits.abs().max(-1).values.cpu().numpy()
        tie = gap < 1e-4 * scale
        differ = logits.argmax(-1).cpu().numpy() != out
        bad = np.flatnonzero(differ & ~tie)
        check(not bad.size,
              f"{arch} fp32: prompt {i}: served tokens differ from the teacher-forced argmax at "
              f"{bad.tolist()}, top-2 gaps {gap[bad].tolist()} against 1e-4 x max|logit| "
              f"{(1e-4 * scale[bad]).tolist()}")
        near += int(tie.sum())
    peak = torch.cuda.max_memory_allocated() / 1e9
    what = ", ".join(f"{k} {v}" for k, v in overrides.items())
    tf = (f"served tokens equal the teacher-forced argmax ({near} positions with a top-2 gap "
          f"below 1e-4 x max|logit| exempt)" if teacher_forced else
          "teacher forcing not gated (it never reads the quantised cache)")
    print(f"[{tag}] {arch} full width, {n_layers} layers, fp32{', ' + what if what else ''}: "
          f"{len(prompts)} requests ({[len(p) for p in prompts]} tokens) x {new} new: batch "
          f"tokens equal solo tokens; {tf}; peak memory {peak:.2f} GB; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"near_ties": near}


# ----------------------------------------------------------------------
# phases 12, 12b, 12c: the encdec and vlm families, through Model.prefill
# and Model.decode_step (ServeEngine serves token prompts only)
# ----------------------------------------------------------------------
# 12: speech-to-text translation: 16 requests of 1,024 stub frames in two
# batches of 8, decoder prompts of 4-32 tokens (a language tag and a
# prefix), 64 new tokens each
S12_REQUESTS, S12_SLOTS, S12_PLENS, S12_NEW, S12_MAX_LEN = 16, 8, (4, 32), 64, 128
# 12b: image chat on internvl2-76b at 8 of its 80 layers (its 80 are 141 GB
# of bf16 weights): 8 requests of 256 stub patches, prompts of 256-2,048
# tokens, 16 new tokens; the cache holds the prefix: 256 + 2,048 + 16
I12_LAYERS, I12_REQUESTS, I12_PLENS, I12_NEW, I12_MAX_LEN = 8, 8, (256, 2048), 16, 2320


def frontend_inputs(cfg, n: int, plens, seed: int):
    """n prompts uniform on ``plens`` tokens and their stub frames or
    patches (n, F, D): N(0, 1) float32 from a numpy seed, as
    ``TokenPipeline`` makes them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(plens[0], plens[1] + 1, n)
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).astype(np.int32) for m in lens]
    front = rng.normal(0, 1, (n, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return prompts, front


def frontend_batch(model, prompts, front, new: int, max_len: int, profile_last: int = 0,
                   tag: str = "front") -> dict:
    """One batch served greedily through ``Model.prefill`` and
    ``Model.decode_step``, as the reference's tests drive these families:
    prompts left-aligned and padded, prefill at their lengths, then
    ``new - 1`` decode steps at lengths that count a vlm model's prefix,
    each step's tokens copied to the host.  The last ``profile_last`` steps
    run under torch.profiler (``profile_steps``) and are left out of
    ``step_ms``.  Returns the tokens (rows x new), the prefill's seconds,
    each timed step's ms and rows' lengths, the profile, the final cache and
    fill, and whether every logit was finite."""
    import numpy as np
    import torch

    cfg = model.cfg
    dev = model.device
    n_prefix = cfg.frontend_len if cfg.family == "vlm" else 0
    plens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), int(plens.max())), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             ("patches" if cfg.family == "vlm" else "frames"): torch.as_tensor(front, device=dev)}
    lens = torch.as_tensor(plens, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, max_len, lengths=lens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    st = {"tok": torch.argmax(logits, -1).to(torch.int32), "fill": lens + n_prefix,
          "finite": torch.isfinite(logits).all()}
    out = [st["tok"].cpu().numpy()]

    def step():
        logits, _ = model.decode_step(cache, st["tok"], st["fill"])
        st["finite"] &= torch.isfinite(logits).all()
        st["fill"], st["tok"] = st["fill"] + 1, torch.argmax(logits, -1).to(torch.int32)
        out.append(st["tok"].cpu().numpy())

    step_ms, step_lengths = [], []
    for _ in range(new - 1 - profile_last):
        step_lengths.append((st["fill"] + 1).tolist())
        t = time.perf_counter()
        step()
        step_ms.append(1e3 * (time.perf_counter() - t))
    prof = None
    if profile_last:
        prof = profile_steps(step, profile_last, float(np.median(step_ms)), tag)
    return {"tokens": np.stack(out, 1), "prefill_s": prefill_s, "step_ms": step_ms,
            "step_lengths": step_lengths, "profile": prof, "cache": cache, "fill": st["fill"],
            "batch": batch, "lens": lens, "finite": bool(st["finite"])}


def frontend_probe(model, res: dict) -> tuple:
    """The kernel against its plain version on the model's own cache after
    serving, at layer 0: its self-attention over each row's fill and (encdec)
    its cross-attention over all F frames, q from the last token's
    embedding.  Returns (max abs error, {"self": device ms a call,
    "cross": ...})."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.models.layers import attn_qkv, rms_norm

    cfg, cache, fill = model.cfg, res["cache"], res["fill"]
    lp = model.layers[0]
    x = model._embed(torch.as_tensor(res["tokens"][:, -1:], device=model.device).long())
    q = attn_qkv(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps), cfg, fill.long()[:, None])[0]
    calls = {"self": (q[:, 0].float().contiguous(), cache["k"][0], cache["v"][0],
                      fill.to(torch.int32))}
    if cfg.is_encdec:
        b, f = fill.shape[0], cfg.frontend_len
        h = rms_norm(x, lp.ln_x, cfg.norm_eps) @ lp.xattn.wq
        calls["cross"] = (h.reshape(b, cfg.n_kv_heads, -1, cfg.dh).float().contiguous(),
                          *(cache[n].transpose(1, 2).contiguous() for n in ("xk", "xv")),
                          torch.full((b,), f, dtype=torch.int32, device=model.device))
    err, ms = 0.0, {}
    for name, args in calls.items():
        out, ref = decode_attention_cuda(*args), decode_attention_ref(*args)
        e = float((out - ref).abs().max())
        check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
              f"{cfg.name}: decode_attention ({name}) on the model's cache: err {e}")
        err = max(err, e)
        ms[name] = device_ms(lambda: decode_attention_cuda(*args), 10, expect=1)[0]
    return err, ms


def frontend_serving(arch: str, n_requests: int, slots: int, plens, new: int, max_len: int,
                     tag: str, n_layers=None, idle_steps: int = 4) -> dict:
    """Phases 12 and 12b: ``arch`` at full width in bf16 (random weights
    from a seed; ``n_layers`` cuts the depth), ``n_requests`` in batches
    of ``slots`` through :func:`frontend_batch`, the last batch's last
    ``idle_steps`` steps profiled.  Gated: decode_attention launched once
    a layer a step (twice with cross-attention), every logit finite and
    every token in the vocabulary, the kernel equal to its plain version
    on the model's cache (self and cross)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    enc = (f", {cfg.n_enc_layers} encoder layers over {cfg.frontend_len} stub frames"
           if cfg.is_encdec else f", {cfg.frontend_len} stub patches before each prompt")
    print(f"[{tag}] {arch}: {cfg.n_layers} decoder layers{enc}, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.dh}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"bf16; {w_bytes / 1e9:.3f} GB of weights initialised on the card in {init_s:.2f} s",
          flush=True)
    prompts, front = frontend_inputs(cfg, n_requests, plens, seed=12)
    per_step = (2 if cfg.is_encdec else 1) * cfg.n_layers
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    runs = []
    for i in range(0, n_requests, slots):
        last = i + slots >= n_requests
        runs.append(frontend_batch(model, prompts[i:i + slots], front[i:i + slots], new,
                                   max_len, profile_last=idle_steps if last else 0, tag=tag))
    serve_s = time.perf_counter() - t0
    launches = ops.kernel_launches()
    n_steps = sum(new - 1 for _ in runs)
    check(launches["decode_attention"] == per_step * n_steps,
          f"{arch}: decode_attention launched {launches['decode_attention']} times over "
          f"{n_steps} decode steps, not {per_step} a step")
    check(all(r["finite"] for r in runs), f"{arch}: a logit was not finite")
    tokens = np.concatenate([r["tokens"] for r in runs])
    check(tokens.shape == (n_requests, new) and tokens.min() >= 0
          and tokens.max() < cfg.vocab_size, f"{arch}: tokens out of the vocabulary")
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [m for r in runs for m in r["step_ms"]]
    step_lengths = [ln for r in runs for ln in r["step_lengths"]]
    med = float(np.median(step_ms))
    bounds = decode_step_bounds(model, step_lengths[int(np.argsort(step_ms)[len(step_ms) // 2])])
    err, probe_ms = frontend_probe(model, runs[-1])
    # prefill, and the encoder alone, by CUDA events on the last batch
    last = runs[-1]
    prefill_ev = cuda_ms(lambda: model.prefill(last["batch"], max_len, lengths=last["lens"]), 1)
    enc_ev = (cuda_ms(lambda: model._encoder(last["batch"]["frames"]), 1) if cfg.is_encdec
              else None)
    idle, attn_ms, kernels = last["profile"]
    n_tok = tokens.size
    plen_all = [len(p) for p in prompts]
    print(f"[{tag}] served {n_requests} requests ({n_tok} tokens; prompts {min(plen_all)}-"
          f"{max(plen_all)}) in batches of {slots} in {serve_s:.2f} s: {n_tok / serve_s:.1f} "
          f"tokens/s end to end; prefill per batch " + ", ".join(
              f"{r['prefill_s']:.3f} s" for r in runs) + f"; by CUDA events {prefill_ev:.2f} ms"
          + (f", the encoder {enc_ev:.2f} ms of it ({enc_ev / prefill_ev:.3f})" if enc_ev
             else f" over {cfg.frontend_len} prefix + up to {max(plen_all)} prompt positions"),
          flush=True)
    cross = (f" + cross K/V {bounds['cross_bytes'] / 1e9:.3f} GB ({cfg.n_layers} reads)"
             if cfg.is_encdec else "")
    print(f"[{tag}] decode: {len(step_ms)} timed steps, median {med:.3f} ms/step (p90 "
          f"{np.percentile(step_ms, 90):.3f}), {slots / med * 1e3:.1f} tokens/s in decode; bound "
          f"{bounds['weights']:.3f} ms/step (weights read {bounds['read_bytes'] / 1e9:.3f} GB + "
          f"self K/V {bounds['kv_bytes'] / 1e9:.3f} GB{cross} at 3.35 TB/s), step / bound "
          f"{med / bounds['weights']:.3f}; peak memory {peak:.2f} GB", flush=True)
    split = " + ".join(f"{cfg.n_layers} {k} x {v:.4f}" for k, v in probe_ms.items())
    est = cfg.n_layers * sum(probe_ms.values())
    print(f"[{tag}] decode_attention launches {launches['decode_attention']} = {per_step} x "
          f"{n_steps} steps; kernel vs plain on the model's cache (layer 0"
          f"{', self and cross' if cfg.is_encdec else ''}): max_abs_err {err:.3g}; device ms a "
          f"step {split} = {est:.4f} (profiler: {attn_ms:.4f})", flush=True)
    prefill_s = [r["prefill_s"] for r in runs]
    del model, runs, last
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(f"[{tag}] phase took {secs:.1f} s", flush=True)
    return {"launches": launches, "step_ms": med, "bound_ms": bounds["weights"], "bounds": bounds,
            "idle_share": idle, "kernels_per_step": kernels, "attention_ms_per_step": attn_ms,
            "attention_ms_split": {k: cfg.n_layers * v for k, v in probe_ms.items()},
            "cache_err": err, "tokens_per_s": n_tok / serve_s, "peak_gb": peak,
            "prefill_s": prefill_s, "prefill_event_ms": prefill_ev, "encoder_event_ms": enc_ev,
            "seconds": secs}


def frontend_fp32(arch: str, n_layers: int, plens, tag: str = "frontend-fp32", new: int = 16) -> dict:
    """Phase 12c: ``arch`` at full width, ``n_layers`` deep (an encdec
    model's encoder too), fp32: 4 requests (ragged on ``plens``) served in
    one batch give each the tokens it gets alone, and those equal the
    argmax of one teacher-forced ``forward`` over prompt + output (its
    frames or patches included) but where its top-2 gap is below 1e-4 x
    max|logit|."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    t0 = time.perf_counter()
    over = {"n_layers": n_layers, "dtype": "float32"}
    if get_config(arch).is_encdec:
        over["n_enc_layers"] = n_layers
    cfg = dataclasses.replace(get_config(arch), **over)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    prompts, front = frontend_inputs(cfg, 4, plens, seed=3)
    n_prefix = cfg.frontend_len if cfg.family == "vlm" else 0
    max_len = n_prefix + max(len(p) for p in prompts) + new
    batch = frontend_batch(model, prompts, front, new, max_len)["tokens"]
    key = "patches" if cfg.family == "vlm" else "frames"
    near = 0
    for i, p in enumerate(prompts):
        solo = frontend_batch(model, [p], front[i:i + 1], new, max_len)["tokens"][0]
        check(np.array_equal(solo, batch[i]), f"{arch} fp32: prompt {i} ({len(p)} tokens) "
                                              f"served alone gives {solo}, in the batch {batch[i]}")
        seq = np.concatenate([p, batch[i, :-1].astype(np.int32)])[None]
        h, _ = model._hidden({"tokens": seq, key: front[i:i + 1]})
        logits = model._logits(h[:, len(p) - 1:])[0]
        top2 = logits.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        scale = logits.abs().max(-1).values.cpu().numpy()
        tie = gap < 1e-4 * scale
        bad = np.flatnonzero((logits.argmax(-1).cpu().numpy() != batch[i]) & ~tie)
        check(not bad.size,
              f"{arch} fp32: prompt {i}: served tokens differ from the teacher-forced argmax at "
              f"{bad.tolist()}, top-2 gaps {gap[bad].tolist()} against 1e-4 x max|logit| "
              f"{(1e-4 * scale[bad]).tolist()}")
        near += int(tie.sum())
    peak = torch.cuda.max_memory_allocated() / 1e9
    depth = (f"{n_layers} encoder + {n_layers} decoder layers" if cfg.is_encdec
             else f"{n_layers} layers")
    print(f"[{tag}] {arch} full width, {depth}, fp32: 4 requests ({[len(p) for p in prompts]} "
          f"tokens, {cfg.frontend_len} stub {key} each) x {new} new: batch tokens equal solo "
          f"tokens; served tokens equal the teacher-forced argmax ({near} positions with a "
          f"top-2 gap below 1e-4 x max|logit| exempt); peak memory {peak:.2f} GB; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"near_ties": near}


# ----------------------------------------------------------------------
# phase 10: training gemma2-2b on the card
# ----------------------------------------------------------------------
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, dense
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_STEPS, TRAIN_WARM = 12, 2
TRAIN_LR = 3e-4           # the reference train CLI's default --lr, under schedule.constant


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def train_fp32_checks(pipe) -> dict:
    """10a: gemma2-2b at full width, 2 layers, fp32 (TF32 off), one batch
    of phase 10's traffic.  ``Model.loss``'s ce equals the cross-entropy of
    ``forward``'s full (B, S, V) logits; one step with grad_accum 2 equals
    one with grad_accum 1 from the same state: the losses within 1e-5
    relative, the first moments m (0.1 x the clipped grad after one step)
    within 1e-5 of each leaf's max|m|.  m, not the params: a first Adam
    step is ~lr * sign(g), so a grad within rounding of zero can move a
    param by 2 lr either way."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step, schedule

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(GEMMA), n_layers=2, dtype="float32")
    batch = pipe.batch_at(0)
    runs = []
    for accum in (1, 2):
        model = Model(cfg, device="cuda")
        state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0))
        runs.append((model, state, make_train_step(model, AdamWConfig(lr=TRAIN_LR),
                                                   schedule.constant, grad_accum=accum)))
    model = runs[0][0]
    with torch.no_grad():
        _, met = model.loss(batch)
        logits, _ = model.forward(batch)
        lab = torch.as_tensor(batch["labels"], device="cuda").long()
        full = (torch.logsumexp(logits, -1) - logits.gather(-1, lab[..., None])[..., 0]).mean()
        del logits
    ce_gap = _rel(met["ce"], full)
    check(ce_gap <= 1e-5, f"[train-fp32] Model.loss ce {float(met['ce'])!r} differs from the "
                          f"full-logits CE {float(full)!r} by {ce_gap:.3g} relative")
    out = [step(state, batch) for _, state, step in runs]
    (s1, m1), (s2, m2) = out
    loss_gap = _rel(m2["loss"], m1["loss"])
    check(loss_gap <= 1e-5, f"[train-fp32] grad_accum 2 loss {float(m2['loss'])!r} against "
                            f"grad_accum 1 {float(m1['loss'])!r}")
    worst = 0.0
    for k, a in s1.opt.m.items():
        gap = float((s2.opt.m[k] - a).abs().max()) / max(float(a.abs().max()), 1e-30)
        worst = max(worst, gap)
        check(gap <= 1e-5, f"[train-fp32] m[{k}]: grad_accum 2 differs from 1 by {gap:.3g} of "
                           f"max|m|")
    secs = time.perf_counter() - t0
    print(f"[train-fp32] gemma2-2b full width, 2 layers, fp32, B={TRAIN_BATCH} S={TRAIN_SEQ}: "
          f"Model.loss ce {float(met['ce']):.6f} = the full-logits CE within {ce_gap:.3g} "
          f"relative; grad_accum 2 against 1: loss {float(m2['loss']):.6f} against "
          f"{float(m1['loss']):.6f} ({loss_gap:.3g} relative), every m leaf within "
          f"{worst:.3g} of its max|m| (grad norm {float(m1['grad_norm']):.4f}); {secs:.1f} s",
          flush=True)
    del runs, out, s1, s2, model, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"ce_gap": ce_gap, "loss_gap": loss_gap, "m_gap": worst, "seconds": secs}


def train_step_bound(model, batch: int, seq: int) -> dict:
    """The least time of one train step: the larger of its matmul FLOPs
    at 989 TFLOP/s (bf16) and its optimizer bytes at 3.35 TB/s.  FLOPs are
    8 N T (6 N T forward and backward, 2 N T the recomputed forward), N the
    weights that enter a matmul (every matrix, the tied embedding once as
    the head; its gather is no product), plus causal attention's QK^T and
    PV over the positions each query needs, four times (forward, recompute,
    and the backward's two).  Bytes are every fp32 param, grad, m and v
    read once and param, m and v written once."""
    cfg = model.cfg
    tokens = batch * seq
    n_mm = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    n_all = sum(p.numel() for p in model.parameters())
    keys = sum(sum(min(q + 1, w) for q in range(seq)) for w in model.windows)
    attn = 4 * (2 * 2 * batch * cfg.n_heads * cfg.dh * keys)
    flops = 8 * n_mm * tokens + attn
    bytes_ = 28 * n_all
    t_ops, t_bytes = flops / H100_BF16_FLOPS, bytes_ / H100_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes), "ops_ms": 1e3 * t_ops,
            "bytes_ms": 1e3 * t_bytes, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": bytes_, "n_matmul": n_mm, "n_params": n_all}


def train_phase() -> dict:
    """Phase 10: 10a (``train_fp32_checks``), then gemma2-2b at full width
    and depth, bf16 compute over fp32 masters, on TokenPipeline(vocab
    256,000, seq 1,024, batch 8, seed 0): TRAIN_STEPS steps of AdamW at
    TRAIN_LR, constant schedule.  Gates: every loss and grad norm finite,
    the mean of the last 3 losses below the first, no launch of either
    kernel.  Printed: each step's loss and grad norm, the median of the
    steps after TRAIN_WARM (host clock; each step ends reading its loss),
    tokens/s, peak memory, the step's bound; device busy, idle share and
    CUDA kernels a step under torch.profiler over 2 more steps; and, by
    CUDA events, the forward alone (no_grad), forward + backward, and the
    optimizer update, whose shares of the step estimate the remat's (the
    recompute repeats the forward once) and the optimizer's."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, adamw_update, init_train_state,
                                   make_train_step, schedule)

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 1e9
    ops.reset_kernel_launches()
    cfg = get_config(GEMMA)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=0)
    fp32 = train_fp32_checks(pipe)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda")
    holder = [init_train_state(model, torch.Generator(device="cuda").manual_seed(0))]
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    step = make_train_step(model, opt_cfg, schedule.constant)

    def run(i):
        holder[0], met = step(holder[0], pipe.batch_at(i))
        return float(met["loss"]), float(met["grad_norm"])

    losses, gnorms, walls = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, gn = run(i)
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        gnorms.append(gn)
        print(f"[train] step {i}: loss {loss:.4f}, grad norm {gn:.4f}, {walls[-1]:.1f} ms",
              flush=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(bool(np.isfinite(losses).all() and np.isfinite(gnorms).all()),
          f"[train] a loss or grad norm is not finite: {losses} {gnorms}")
    check(float(np.mean(losses[-3:])) < losses[0],
          f"[train] the loss did not fall: first {losses[0]}, last three {losses[-3:]}")
    step_ms = float(np.median(walls[TRAIN_WARM:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bound = train_step_bound(model, TRAIN_BATCH, TRAIN_SEQ)

    _, wall, busy, ka = _device_busy(torch.device("cuda"),
                                     lambda: [run(TRAIN_STEPS + j) for j in range(2)])
    if busy is None:
        busy_ms = idle = per_step = float("nan")
        print("[train] device time not measured (the profiler saw none)", flush=True)
    else:
        busy_ms, per_step = busy * 1e3 / 2, sum(e.count for e in ka) / 2
        idle = 1.0 - busy_ms / step_ms
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:5]
        print(f"[train] 2 steps under torch.profiler: device busy {busy_ms:.1f} ms/step against "
              f"the un-profiled {step_ms:.1f} (idle share {idle:.3f}; profiled wall "
              f"{wall * 1e3 / 2:.1f} ms/step; {per_step:.0f} CUDA kernels a step); top: "
              + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 2e3:.1f} ms" for e in top),
              flush=True)

    batch = pipe.batch_at(0)
    params = holder[0].params

    def fwd():
        with torch.no_grad():
            model.loss(batch)

    def fwd_bwd():
        total, _ = model.loss(batch)
        return torch.autograd.grad(total, list(params.values()))

    fwd_ms = cuda_ms(fwd, 2)
    fwd_bwd_ms = cuda_ms(fwd_bwd, 1)
    grads = dict(zip(params, fwd_bwd()))
    opt_ms = cuda_ms(lambda: adamw_update(params, grads, holder[0].opt, opt_cfg, 1.0), 3)
    launches = ops.kernel_launches()
    check(launches["decode_attention"] == 0 and launches["masked_l2_topk"] == 0,
          f"[train] training launched a kernel: {launches}")
    secs = time.perf_counter() - t_phase
    print(f"[train] gemma2-2b full width and depth ({cfg.n_layers} layers, "
          f"{bound['n_params'] / 1e9:.3f}B params), bf16 compute over fp32 masters, "
          f"B={TRAIN_BATCH} S={TRAIN_SEQ}, AdamW lr {TRAIN_LR} constant: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (last three mean {np.mean(losses[-3:]):.4f}); median step "
          f"{step_ms:.1f} ms over steps {TRAIN_WARM}-{TRAIN_STEPS - 1} against a bound of "
          f"{bound['bound_ms']:.1f} ms ({bound['bound_by']}: {bound['flops'] / 1e12:.1f} TFLOP at "
          f"989 TFLOP/s = {bound['ops_ms']:.1f} ms; optimizer {bound['bytes'] / 1e9:.1f} GB at "
          f"3.35 TB/s = {bound['bytes_ms']:.1f} ms; {card_line()}), step / bound "
          f"{step_ms / bound['bound_ms']:.2f}; {tokens / step_ms * 1e3:.0f} tokens/s; peak "
          f"{peak:.2f} GB allocated ({before:.2f} GB held before the phase); by CUDA events: "
          f"forward alone {fwd_ms:.1f} ms (remat share ~{fwd_ms / step_ms:.3f}), forward + "
          f"backward {fwd_bwd_ms:.1f} ms, optimizer {opt_ms:.1f} ms (share "
          f"{opt_ms / step_ms:.3f}); kernel launches over phase 10 {launches}; phase 10 took "
          f"{secs:.1f} s", flush=True)
    del model, holder, params, grads, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": gnorms, "step_ms": step_ms, "bound": bound,
            "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": peak, "busy_ms": busy_ms,
            "idle": idle, "kernels_per_step": per_step, "fwd_ms": fwd_ms,
            "fwd_bwd_ms": fwd_bwd_ms, "opt_ms": opt_ms, "launches": launches, "fp32": fp32,
            "seconds": secs}


# ----------------------------------------------------------------------
# phase 9: the serve CLI on the card
# ----------------------------------------------------------------------
# the top-level keys of the reference CLI's ann-trace snapshot (repro.launch.serve
# with --probe-rate > 0), which the port's must have
CLI_SNAPSHOT_KEYS = (
    "backend_counts", "batch_sizes", "deadline_flushes", "deadline_met", "deadline_missed",
    "engine", "fill_rate", "latency_by_tier", "latency_virtual", "mean_expansions", "n_batches",
    "n_compactions", "n_completed", "n_deletes", "n_upserts", "plan_counts", "probe",
    "queue_wait_virtual", "span_summary", "wall")


def cli_phase() -> dict:
    """``repro_torch.launch.serve.main`` in-process: the ann-trace mode over
    a 200,000-row corpus with 4 shards and the recall probe, then ``--mode
    lm`` for gemma2-2b, olmoe-1b-7b, hymba-1.5b and xlstm-1.3b (reduced, as
    the reference's)."""
    import contextlib
    import io
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spans = Path(tmp) / "spans.jsonl"
        ops.reset_kernel_launches()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            snap = serve.main(["--mode", "ann-trace", "--corpus", "200000", "--requests", "400",
                               "--shards", "4", "--probe-rate", "0.1", "--trace-out",
                               str(spans)])
        launches = ops.kernel_launches()
        n_spans = sum(1 for _ in spans.open())
    check(tuple(sorted(snap)) == CLI_SNAPSHOT_KEYS,
          f"the CLI's snapshot keys {sorted(snap)} are not the reference's {CLI_SNAPSHOT_KEYS}")
    check(snap["n_completed"] == 400, f"the CLI completed {snap['n_completed']} of 400 requests")
    check(launches["masked_l2_topk"] > 0, "the CLI's ann-trace launched masked_l2_topk no time")
    ann_s = time.perf_counter() - t0
    lines = text.getvalue().splitlines()
    print(f"[cli] ann-trace --corpus 200000 --requests 400 --shards 4 --probe-rate 0.1: "
          f"{ann_s:.1f} s; snapshot keys as the reference's; {n_spans} spans written; "
          f"masked_l2_topk launches {launches['masked_l2_topk']}; plans {snap['plan_counts']}; "
          + next(ln for ln in lines if ln.startswith("runtime exec wall")), flush=True)
    for arch in (GEMMA, OLMOE, HYMBA, XLSTM):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            results = serve.main(["--mode", "lm", "--arch", arch, "--requests", "8",
                                  "--new-tokens", "16"])
        check(sorted(results) == list(range(8)) and all(len(t) == 16 for t in results.values()),
              f"the CLI's --mode lm --arch {arch} did not serve every request its 16 tokens")
        print(f"[cli] --mode lm --arch {arch}: " + text.getvalue().splitlines()[0], flush=True)
    train_cli()
    return {"launches": launches, "seconds": time.perf_counter() - t0}


def plain_losses(arch: str, steps: int, seq: int, batch: int, lr: float = 3e-4) -> list:
    """The losses of the plain one-device step (``make_train_step``, no
    mesh) over the train CLI's batches, from its init: what the CLI's mesh
    path must give on one rank."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = get_config(arch).reduced()
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                         frontend=cfg.frontend, frontend_len=cfg.frontend_len,
                         d_model=cfg.d_model)
    model = Model(cfg, device="cuda")
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, AdamWConfig(lr=lr))
    out = []
    for i in range(steps):
        state, met = step(state, pipe.batch_at(i))
        out.append(float(met["loss"]))
    return out


def train_cli() -> None:
    """The reference's train-CLI test (tests/test_train.py) on the card:
    ``repro_torch.launch.train.main`` for hymba-1.5b reduced, 8 steps with a
    checkpoint every 4, over the local mesh (a 1-rank NCCL group it makes
    itself, FSDP2 over its one rank), gives 8 losses within 1e-6 of the
    plain one-device step's over the same batches; run again on the same
    directory it resumes at step 8 and trains nothing."""
    import contextlib
    import io
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--arch", HYMBA, "--reduced", "--steps", "8", "--seq-len", "32", "--batch", "4",
                "--ckpt-dir", tmp, "--ckpt-every", "4"]
        ops.reset_kernel_launches()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            losses = train.main(argv)
            again = train.main(argv)
        train_launches = ops.kernel_launches()
    check(len(losses) == 8 and all(math.isfinite(x) for x in losses),
          f"the train CLI gave {losses}, not 8 finite losses")
    check(not dist.is_initialized(), "the train CLI left its process group behind")
    plain = plain_losses(HYMBA, 8, 32, 4)
    gap = max(abs(a - b) for a, b in zip(losses, plain))
    check(gap <= 1e-6, f"the train CLI's mesh-path losses {losses} differ from the plain "
                       f"step's {plain} by {gap:.3g}")
    check(again == [], f"the train CLI's resume trained {len(again)} more steps")
    check(sum(train_launches.values()) == 0, f"the train CLI launched a kernel: {train_launches}")
    lines = text.getvalue().splitlines()
    print(f"[cli] train --arch {HYMBA} --reduced --steps 8 --seq-len 32 --batch 4 --ckpt-every "
          f"4 over the local mesh (1-rank NCCL, FSDP2): 8 losses {[round(x, 4) for x in losses]}"
          f", within {gap:.3g} of the plain one-device step's, then a clean resume ("
          + "; ".join(ln for ln in lines if ln.startswith(("resuming", "nothing")))
          + f"); {time.perf_counter() - t1:.1f} s", flush=True)


# ----------------------------------------------------------------------
# phase 11: qwen3-32b at full width and depth, held to the dry-run
# ----------------------------------------------------------------------
QWEN32 = "qwen3-32b"
# 4 requests, not 8: the script passed 1,000 s with 8 (PERF.md section 4);
# the 4 are served as one batch of 4 rows in the 8 slots
Q32_SLOTS, Q32_MAX_LEN, Q32_REQUESTS, Q32_NEW = 8, 2088, 4, 16
Q32_ROWS = min(Q32_REQUESTS, Q32_SLOTS)
ARG_GATE = 0.01           # allocated weights + cache against the dry-run's argument bytes
PEAK_BAND = 0.10          # the measured peak against the traced prefill's predicted peak


def dryrun_predictions(prefill_len: int) -> dict:
    """Step 1 of phase 11, before anything of it is allocated: the dry-run
    (``repro_torch.launch.dryrun.cell_record``, fake tensors on a fake
    1-rank group) of qwen3-32b's decode step at the served batch's
    Q32_ROWS rows over a 2,088-position cache on a (1, 1) mesh, and of its
    prefill of those prompts padded to ``prefill_len``; the analytic memory
    term of the decode cell; ``decode_step_bounds`` of a fake model with
    every row at 2,088 positions."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import Model

    t0 = time.perf_counter()
    cfg = get_config(QWEN32)
    dec = dryrun.cell_record(cfg, ShapeSpec("decode_2088", Q32_MAX_LEN, Q32_ROWS, "decode"),
                             mesh_shape=(1, 1), arch=QWEN32)
    pre = dryrun.cell_record(cfg, ShapeSpec(f"prefill_{prefill_len}", prefill_len, Q32_ROWS,
                                            "prefill"), mesh_shape=(1, 1), arch=QWEN32)
    with FakeTensorMode():
        bounds = decode_step_bounds(Model(cfg, device="cpu"), [Q32_MAX_LEN] * Q32_ROWS)
    mem_d, mem_p = dec["memory_analysis"], pre["memory_analysis"]
    out = {"args": mem_d["argument_bytes"], "temp": mem_d["temp_bytes"],
           "prefill_peak": mem_p["argument_bytes"] + mem_p["temp_bytes"],
           "memory_s": dec["roofline"]["memory_s"], "hbm_bytes": dec["roofline"]["hbm_bytes"],
           "bound_ms": bounds["weights"], "bound_bytes": bounds["read_bytes"]
           + bounds["kv_bytes"], "seconds": time.perf_counter() - t0}
    print(f"[qwen32] dry-run predictions before allocating (1 x 1 mesh, {out['seconds']:.1f} s "
          f"on the host): argument bytes {out['args'] / 1e9:.3f} GB (bf16 weights, the KV cache "
          f"of {Q32_ROWS} x {Q32_MAX_LEN}, tokens, lengths); traced decode temp "
          f"{out['temp'] / 1e9:.3f} GB; traced peak of the prefill at {prefill_len} positions "
          f"(weights, batch, the cache it makes, activations; depths {pre['trace_depths']}) "
          f"{out['prefill_peak'] / 1e9:.3f} GB; analytic memory_s {out['memory_s'] * 1e3:.2f} ms ({out['hbm_bytes'] / 1e9:.2f} "
          f"GB at the datasheet's 3.35 TB/s: the weights counted twice, as the reference's FSDP "
          f"model does); decode_step_bounds {out['bound_ms']:.2f} ms ({out['bound_bytes'] / 1e9:.2f}"
          f" GB)", flush=True)
    return out


def qwen32_phase(tr: dict) -> dict:
    """Phase 11: the dry-run's predictions (``dryrun_predictions``), then
    qwen3-32b through ``lm_serving`` at all 64 layers in bf16 (Q32_REQUESTS
    requests, prompts uniform on 256-2,048, 16 new tokens, 8 slots,
    max_len 2,088),
    with lm_serving's gates (64 decode_attention launches a step, the kernel
    against its plain version on the model's cache).  Gated: the bytes
    allocated by init plus the cache's within ARG_GATE of the predicted
    argument bytes (a check that the dry-run's argument bytes are the
    model's own: both count the same parameters and cache shapes); the
    peak within PEAK_BAND of the traced prefill's predicted peak (the
    prediction of fit).  Printed, not gated: the peak against the traced
    decode step's and the card's memory; the decode step's median against
    the analytic memory term and decode_step_bounds; phase 10's gemma2-2b
    train step against ``analytic_cost`` of train_1024 on a (1, 1) mesh."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.analytics import analytic_cost
    from repro_torch.launch.roofline import HW, analyse

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    plens = np.random.default_rng(0).integers(256, 2049, Q32_REQUESTS)
    pred = dryrun_predictions(int(plens.max()))
    out = lm_serving(QWEN32, prompt_lens=plens, slots=Q32_SLOTS, new=Q32_NEW,
                     max_len=Q32_MAX_LEN, tag="qwen32", idle_steps=4)
    cfg = out["model"].cfg
    check(cfg.n_layers == 64 and cfg.d_model == 5120 and cfg.dtype == "bfloat16",
          f"[qwen32] served {cfg.n_layers} layers of width {cfg.d_model} in {cfg.dtype}")
    measured = out["init_alloc"] + out["cache_nbytes"][0] + 2 * 4 * Q32_ROWS
    gap = abs(measured - pred["args"]) / pred["args"]
    check(gap <= ARG_GATE, f"[qwen32] allocated weights + cache {measured} bytes against the "
                           f"dry-run's argument bytes {pred['args']}: {gap:.4f} apart")
    total = torch.cuda.get_device_properties(0).total_memory
    peak = out["peak_gb"] * 1e9
    peak_gap = peak / pred["prefill_peak"] - 1
    check(abs(peak_gap) <= PEAK_BAND,
          f"[qwen32] peak {peak} bytes against the traced prefill's predicted peak "
          f"{pred['prefill_peak']}: {peak_gap:+.4f} apart")
    print(f"[qwen32] argument bytes consistent: allocated by init {out['init_alloc'] / 1e9:.3f} "
          f"GB + cache {out['cache_nbytes'][0] / 1e9:.3f} GB + tokens and lengths = "
          f"{measured / 1e9:.3f} GB against the dry-run's {pred['args'] / 1e9:.3f} GB "
          f"({gap:.2e} apart, gate {ARG_GATE}); fit: peak {peak / 1e9:.3f} GB against the "
          f"traced prefill's predicted {pred['prefill_peak'] / 1e9:.3f} GB ({peak_gap:+.4f}, "
          f"gate {PEAK_BAND}) and the traced decode step's "
          f"{(pred['args'] + pred['temp']) / 1e9:.3f} GB, of the card's {total / 1e9:.3f} GB",
          flush=True)
    med = out["step_ms"]
    print(f"[qwen32] decode step median {med:.3f} ms: / analytic memory_s "
          f"{pred['memory_s'] * 1e3:.2f} ms = {med / (pred['memory_s'] * 1e3):.3f}; / "
          f"decode_step_bounds {pred['bound_ms']:.2f} ms = {med / pred['bound_ms']:.3f}; "
          f"lm_serving's own bound at the median step's lengths {out['bound_ms']:.3f} ms "
          f"({card_line()})", flush=True)
    g_cfg = get_config(GEMMA)
    ac = analytic_cost(g_cfg, ShapeSpec("train_1024", TRAIN_SEQ, TRAIN_BATCH, "train"), 1, 1)
    terms = analyse({}, 1, analytic=ac)
    step = tr["step_ms"]
    print(f"[qwen32] phase 10's gemma2-2b train step {step:.1f} ms beside analytic_cost "
          f"(train_1024, 1 x 1): {ac.flops / 1e12:.2f} TFLOP, compute_s "
          f"{terms.compute_s * 1e3:.2f} ms at the datasheet's {HW['peak_flops'] / 1e12:.1f} "
          f"TFLOP/s (step / that {step / (terms.compute_s * 1e3):.3f}), "
          f"{ac.hbm_bytes / 1e9:.2f} GB of traffic, memory_s {terms.memory_s * 1e3:.2f} ms; "
          f"train_step_bound {tr['bound']['bound_ms']:.1f} ms (step / that "
          f"{step / tr['bound']['bound_ms']:.3f})", flush=True)
    del out["model"]
    gc.collect()
    torch.cuda.empty_cache()
    out.update(pred=pred, measured_args=measured, arg_gap=gap, peak_gap=peak_gap,
               total_memory=total,
               seconds=time.perf_counter() - t_phase)
    print(f"[qwen32] phase 11 took {out['seconds']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------------
# phase 13: tensor-parallel training, two processes sharing the card
# ----------------------------------------------------------------------
TP_STEPS, TP_BATCH, TP_SEQ = 3, 2, 512
TP_LAYERS = 13            # of gemma2-2b's 26: cut to half for the script's time, which
                          # passed 1,080 s on a slow host with all 26
TP_LR = 3e-4
TP_SAMPLES = 4096         # elements of each leaf held one by one
TP_TIMEOUT = 240          # seconds for a rank's reply
TP_P_CLOSE = 1e-5         # a param element this close (and 1e-5 of it) to the one-process run's
TP_P_FAR_SHARE = 1e-4     # ... on all but this share of the sampled param elements


def tp_band(part: str, leaf: dict) -> float:
    """Phase 13's band for each element of ``part`` (p, m or v) of a leaf
    against the one-process run: params 2 x lr a step (a first Adam step
    moves a weight by lr x g / (|g| + eps), which rounding changes where g
    is near eps), moments 1e-4 of the leaf's largest |value|."""
    return 2 * TP_LR * TP_STEPS if part == "p" else 1e-4 * leaf[part]["max"]


def tp_far(got, want):
    """The param elements of ``got`` past TP_P_CLOSE of ``want``'s."""
    return abs(got - want) > TP_P_CLOSE + TP_P_CLOSE * abs(want)


def tp_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(GEMMA), dtype="float32", n_layers=TP_LAYERS)


def tp_pipe(cfg):
    from repro_torch.data import TokenPipeline

    return TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TP_SEQ, global_batch=TP_BATCH,
                         seed=0)


def tp_reference(cfg) -> dict:
    """Phase 13's one-process run on the card: ``make_train_step`` over
    the whole batch, TP_STEPS steps.  Kept on the host: its losses and
    grad norms, and for every leaf of params, m and v its fp64 sum, its
    largest |value| and TP_SAMPLES elements at seeded flat indices (the
    same indices for a leaf's p, m and v), and the initial params at those
    indices (what a rank that applied no update would hold)."""
    import numpy as np
    import torch

    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step, schedule

    pipe = tp_pipe(cfg)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda")
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, AdamWConfig(lr=TP_LR), schedule.constant)
    rng = np.random.default_rng(0)
    leaves = {}
    with torch.no_grad():
        for k, p in state.params.items():
            idx = np.sort(rng.integers(0, p.numel(), min(p.numel(), TP_SAMPLES)))
            leaves[k] = {"shape": tuple(p.shape), "idx": idx,
                         "p0": p.reshape(-1)[torch.as_tensor(idx, device=p.device)]
                         .double().cpu().numpy()}
    losses, gnorms, walls = [], [], []
    for i in range(TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, pipe.batch_at(i))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        for k, p in state.params.items():
            leaf = leaves[k]
            at = torch.as_tensor(leaf["idx"], device=p.device)
            for part, t in (("p", p), ("m", state.opt.m[k]), ("v", state.opt.v[k])):
                leaf[part] = {"sum": float(t.double().sum()), "max": float(t.abs().max()),
                              "at": t.reshape(-1)[at].double().cpu().numpy()}
    out = {"losses": losses, "grad_norms": gnorms, "walls": walls, "leaves": leaves,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_hold(rank: int, state, axis, ref: dict) -> dict:
    """A rank's blocks against the one-process run's samples: for each
    part the largest gap over its ``tp_band``, the elements compared, the
    param elements past TP_P_CLOSE (``far``), and the fp64 sums of its
    blocks."""
    import numpy as np
    import torch

    worst = {part: (0.0, "") for part in "pmv"}
    sums = {part: {} for part in "pmv"}
    n = far = 0
    with torch.no_grad():
        for k, leaf in ref["leaves"].items():
            coords = list(np.unravel_index(leaf["idx"], leaf["shape"]))
            keep = np.ones(len(leaf["idx"]), bool)
            dim = axis.dims.get(k)
            if dim is not None:
                size = leaf["shape"][dim] // axis.n
                keep = (coords[dim] >= rank * size) & (coords[dim] < (rank + 1) * size)
                coords[dim] = coords[dim] - rank * size
            n += int(keep.sum())
            at = tuple(torch.as_tensor(c[keep]) for c in coords)
            for part, tree in (("p", state.params), ("m", state.opt.m), ("v", state.opt.v)):
                t = tree[k]
                t = t.to_local() if hasattr(t, "to_local") else t
                sums[part][k] = float(t.double().sum())
                got = t[tuple(c.to(t.device) for c in at)].double().cpu().numpy()
                gap = float(np.abs(got - leaf[part]["at"][keep]).max()) if keep.any() else 0.0
                ratio = gap / max(tp_band(part, leaf), 1e-30)
                if ratio > worst[part][0]:
                    worst[part] = (ratio, k)
                if part == "p":
                    far += int(tp_far(got, leaf["p"]["at"][keep]).sum())
    return {"worst": worst, "sums": sums, "compared": n, "far": far}


# phase 13b: gemma2-2b served over the model axis by phase 13's two ranks
# 2 requests and 8 new tokens: cut from 4 and 16 when the script took 1,087.1 s
TPS_REQUESTS, TPS_NEW, TPS_MAX_LEN = 2, 8, 1040
TPS_SEED = 13             # the weights' and the prompts' seed
TPS_SAMPLES = 4096        # cache elements of k and of v held one by one
TPS_LOGIT_REL = 1e-4      # each step's logits: within this x the step's max |logit|
TPS_CACHE_REL = 1e-5      # sampled cache elements: within this x max(1, max |sample|)


def tps_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(GEMMA), dtype="float32")


def tps_prompts(cfg) -> list:
    """TPS_REQUESTS prompts of 256-1,024 tokens (both ends first)."""
    import numpy as np

    rng = np.random.default_rng(TPS_SEED)
    lens = [1024, 256] + [int(n) for n in rng.integers(257, 1024, TPS_REQUESTS - 2)]
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


def tps_model(cfg, axis_group=None):
    """gemma2-2b at full width and depth in fp32, its weights drawn from
    TPS_SEED on the card; cut to this rank's blocks over ``axis_group``."""
    import torch

    from repro_torch.dist.tensor_parallel import shard_model
    from repro_torch.models import Model

    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(TPS_SEED))
    if axis_group is not None:
        shard_model(model, axis_group)
    return model


def tps_serve(model, prompts) -> dict:
    """``prompts`` through ServeEngine in one batch, TPS_NEW new tokens
    each: the tokens, every step's logits (on the host) and wall (host
    clock around a synchronised call), the kernels' launches over the run,
    TPS_SAMPLES seeded elements of the final cache's k and v, and the
    kernel against its plain version on that cache (layer 0, windowed,
    and layer 1, global) over the heads this process's attention reads."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(model, batch_slots=TPS_REQUESTS, max_len=TPS_MAX_LEN)
    rec = {"logits": [], "walls": []}
    prefill, decode = eng._prefill, eng._decode

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn(*args)
        torch.cuda.synchronize()
        rec["walls"].append((time.perf_counter() - t0) * 1e3)
        rec["logits"].append(logits.cpu().numpy())
        rec["cache"] = cache
        return logits, cache

    eng._prefill = lambda batch, lens: timed(prefill, batch, lens)
    eng._decode = lambda cache, tok, lens: timed(decode, cache, tok, lens)
    ops.reset_kernel_launches()
    tokens = eng.run([Request(uid=i, prompt=p, max_new_tokens=TPS_NEW)
                      for i, p in enumerate(prompts)])
    launches = ops.kernel_launches()
    cache = rec.pop("cache")
    rng = np.random.default_rng(TPS_SEED)
    samples = {}
    for name in ("k", "v"):
        idx = torch.as_tensor(rng.integers(0, cache[name].numel(), TPS_SAMPLES), device="cuda")
        samples[name] = cache[name].reshape(-1)[idx].cpu().numpy()
    cfg = model.cfg
    axis = model.model_axis
    kv0, kvl = axis.kv_heads if axis is not None else (0, cfg.n_kv_heads)
    b = len(prompts)
    fill = torch.tensor([len(p) + TPS_NEW - 1 for p in prompts], dtype=torch.int32,
                        device="cuda")
    q = torch.randn((b, kvl, cfg.n_heads // cfg.n_kv_heads, cfg.dh),
                    generator=torch.Generator(device="cuda").manual_seed(7), device="cuda")
    err = 0.0
    for i in (0, 1):
        args = (q, cache["k"][i], cache["v"][i], fill, model.windows[i], cfg.attn_softcap)
        out = decode_attention_cuda(*args, kv0=kv0)
        torch.cuda.synchronize()
        ref = decode_attention_ref(*args, kv0=kv0)
        e = float((out - ref).abs().max())
        check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
              f"[tp-serve] the kernel over heads {kv0}..{kv0 + kvl - 1} of layer {i}'s cache: "
              f"err {e}")
        err = max(err, e)
    return {"tokens": tokens, **rec, "launches": launches, "samples": samples, "cache_err": err,
            "kv_heads": (kv0, kvl)}


def tps_reference(cfg) -> dict:
    """Phase 13b's baseline in this process: the whole model (the ranks'
    weights) serving the same prompts."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = tps_model(cfg)
    build_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    out = tps_serve(model, tps_prompts(cfg))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["build_gb"] = build_gb
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def tps_hold(got: dict, want: dict) -> dict:
    """A rank's serving against the one-process baseline: the largest gap
    of each step's logits over the step's max |logit|, whether the tokens
    are equal, the largest gap of the sampled cache elements over max(1,
    the samples' max |value|)."""
    import numpy as np

    logit_rel = max(float(np.abs(g - w).max()) / float(np.abs(w).max())
                    for g, w in zip(got["logits"], want["logits"]))
    cache_rel = max(float(np.abs(got["samples"][n] - want["samples"][n]).max())
                    / max(1.0, float(np.abs(want["samples"][n]).max())) for n in ("k", "v"))
    return {"logit_rel": logit_rel, "cache_rel": cache_rel,
            "steps": (len(got["logits"]), len(want["logits"])),
            "tokens_equal": got["tokens"] == want["tokens"]}


def tps_rank(rank: int, mesh, sref: dict) -> dict:
    """Phase 13b on one rank: the model built whole from TPS_SEED (one rank
    at a time, so that one whole model exists on the card at once) and cut
    to this rank's blocks, then served and held to the baseline."""
    import torch
    import torch.distributed as dist

    t0 = time.time()
    cfg = tps_config()
    torch.cuda.reset_peak_memory_stats()
    for turn in range(2):
        if turn == rank:
            model = tps_model(cfg, mesh["model"].get_group())
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    t_built = time.time()
    build_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    got = tps_serve(model, tps_prompts(cfg))
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_served = time.time()
    out = {**tps_hold(got, sref), "walls": got["walls"], "launches": got["launches"],
           "cache_err": got["cache_err"], "kv_heads": got["kv_heads"], "peak_gb": peak,
           "build_gb": build_gb,
           "split": model.model_axis.split,
           "times": {"start": t0, "built": t_built, "served": t_served, "held": time.time()}}
    del model, got
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_worker(rank: int, port: int, inbox, outbox) -> None:
    """One of phase 13's two ranks, on cuda:0: a gloo group over
    tcp://localhost, ``make_custom_mesh(1, 2, "cuda")``; it waits for the
    one-process runs' results (``inbox``: phase 13's samples, phase 13b's
    baseline), then builds its state (one rank at a time, so that only one
    whole state exists on the card at once), trains TP_STEPS steps and
    holds its blocks to the samples; then frees it and serves phase 13b
    (``tps_rank``).  Its results go to ``outbox`` as (rank, phase, result),
    or its traceback in place of the result."""
    import datetime
    import traceback

    t_start = time.time()
    try:
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        import torch.distributed as dist

        from repro_torch.device import strict_fp32
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_custom_mesh
        from repro_torch.launch.train import make_sharded_train_step
        from repro_torch.models import Model
        from repro_torch.train import AdamWConfig, init_train_state, schedule

        strict_fp32()
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=TP_TIMEOUT))
        mesh = make_custom_mesh(1, 2, "cuda")
        # paid while the one-process run trains: the CUDA context, and FSDP2's
        # and DTensor's first imports (they register their ops: seconds)
        from torch.distributed.fsdp import fully_shard  # noqa: F401
        from torch.distributed.tensor import distribute_tensor  # noqa: F401

        torch.zeros(1, device="cuda")
        t_ready = time.time()
        ref, sref = inbox.get(timeout=TP_TIMEOUT)
        t_go = time.time()
        cfg = tp_config()
        pipe = tp_pipe(cfg)
        for turn in range(2):
            if turn == rank:
                model = Model(cfg, device="cuda")
                state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0))
                step, state = make_sharded_train_step(model, mesh, state,
                                                      AdamWConfig(lr=TP_LR), schedule.constant)
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        allocated = torch.cuda.memory_allocated()
        t_built = time.time()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_kernel_launches()
        losses, gnorms, walls = [], [], []
        for i in range(TP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, pipe.batch_at(i))
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = ops.kernel_launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        t_trained = time.time()
        held = _tp_hold(rank, state, model.model_axis, ref)
        outbox.put((rank, "13", {
            "losses": losses, "grad_norms": gnorms, "walls": walls, "allocated": allocated,
            "peak_gb": peak, "launches": launches, "sharded": sorted(model.model_axis.dims),
            "split": model.model_axis.split, **held,
            "times": {"start": t_start, "ready": t_ready, "go": t_go, "built": t_built,
                      "trained": t_trained, "held": time.time()}}))
        del model, state, step, ref
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        outbox.put((rank, "13b", tps_rank(rank, mesh, sref)))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        outbox.put((rank, None, traceback.format_exc()))


def tp_phase() -> dict:
    """Phase 13: gemma2-2b at full width and TP_LAYERS layers trained by
    two processes sharing cuda:0 over a (1, 2) mesh, the model axis on a
    gloo group (FSDP2's 1-rank data axis on gloo too), held to the
    one-process step on the card.  Gates: every rank's losses and grad
    norms within 1e-4 relative of the one-process run's; on TP_SAMPLES
    elements of every leaf, each within its ``tp_band`` and all but
    TP_P_FAR_SHARE of the params within TP_P_CLOSE; each leaf's fp64 sum
    within its elements' count times TP_P_CLOSE (params) or the band (m,
    v); the params gate fails the one-process run's initial params (a
    rank that applied no update); each rank's allocated state
    bytes (params, m, v, step) within ARG_GATE of
    ``dryrun.train_state_bytes`` on a (1, 2) mesh; no launch of either
    kernel.  A failed rank or collective fails the phase."""
    import multiprocessing as mp
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "[tp] a process group exists before phase 13")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = tp_config()
    with socket.socket() as so:
        so.bind(("localhost", 0))
        port = so.getsockname()[1]
    ctx = mp.get_context("spawn")
    inboxes, outbox = [ctx.Queue(), ctx.Queue()], ctx.Queue()
    procs = [ctx.Process(target=tp_worker, args=(r, port, inboxes[r], outbox), daemon=True)
             for r in range(2)]
    t_spawn = time.time()
    for p in procs:
        p.start()
    try:
        # while the ranks start: the dry-run's prediction, then the one-process
        # runs (phase 13's training, phase 13b's serving)
        predicted = dryrun.train_state_bytes(cfg, (1, 2))
        ref = tp_reference(cfg)
        t_ref = time.time()
        sref = tps_reference(tps_config())
        t_sref = time.time()
        for box in inboxes:
            box.put((ref, sref))
        got, served = {}, {}
        while len(got) < 2 or len(served) < 2:
            rank, phase, res = outbox.get(timeout=TP_TIMEOUT)
            check(not isinstance(res, str), f"[tp] rank {rank} failed:\n{res}")
            (got if phase == "13" else served)[rank] = res
            if phase == "13" and len(got) == 2:
                t_trained = time.perf_counter()
        for p in procs:
            p.join(timeout=60)
            check(p.exitcode == 0, f"[tp] a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    for r, res in sorted(got.items()):
        for what in ("losses", "grad_norms"):
            rel = max(_rel(a, b) for a, b in zip(res[what], ref[what]))
            check(rel <= 1e-4, f"[tp] rank {r}'s {what} {res[what]} against the one-process "
                                f"{ref[what]}: {rel:.2e} relative")
        for part, (ratio, k) in res["worst"].items():
            check(ratio <= 1.0, f"[tp] rank {r}: {part}.{k} off the one-process run by "
                                f"{ratio:.3f} of its band")
        gap = abs(res["allocated"] - predicted) / predicted
        check(gap <= ARG_GATE, f"[tp] rank {r} allocated {res['allocated']} state bytes against "
                               f"the dry-run's {predicted} ({gap:.2e} apart)")
        check(res["launches"]["masked_l2_topk"] == 0 and res["launches"]["decode_attention"] == 0,
              f"[tp] rank {r}'s training launched a kernel: {res['launches']}")
    compared = got[0]["compared"] + got[1]["compared"]
    far_share = (got[0]["far"] + got[1]["far"]) / compared
    check(far_share <= TP_P_FAR_SHARE,
          f"[tp] {got[0]['far']} + {got[1]['far']} of {compared} sampled param elements "
          f"past {TP_P_CLOSE} of the one-process run's ({far_share:.2e}, gate {TP_P_FAR_SHARE})")
    # the same gate on a rank that applied no update: the initial params
    leaves = ref["leaves"].values()
    idle_far_share = (sum(int(tp_far(leaf["p0"], leaf["p"]["at"]).sum()) for leaf in leaves)
                      / sum(len(leaf["idx"]) for leaf in leaves))
    idle_ratio = max(float(np.abs(leaf["p0"] - leaf["p"]["at"]).max()) / tp_band("p", leaf)
                     for leaf in leaves)
    check(idle_far_share > TP_P_FAR_SHARE,
          f"[tp] the params gate passes the initial params ({idle_far_share:.2e} past "
          f"{TP_P_CLOSE}): it cannot see a rank that applied no update")
    sharded = set(got[0]["sharded"])
    worst_sum = 0.0
    for k, leaf in ref["leaves"].items():
        for part in "pmv":
            mine = (got[0]["sums"][part][k] + got[1]["sums"][part][k] if k in sharded
                    else got[0]["sums"][part][k])
            count = math.prod(leaf["shape"])
            per = TP_P_CLOSE if part == "p" else tp_band(part, leaf)
            ratio = abs(mine - leaf[part]["sum"]) / max(count * per, 1e-30)
            worst_sum = max(worst_sum, ratio)
            check(ratio <= 1.0, f"[tp] {part}.{k}'s sum {mine} against the one-process "
                                f"{leaf[part]['sum']}")
    tp_ms = [float(np.median(got[r]["walls"][1:])) for r in (0, 1)]
    one_ms = float(np.median(ref["walls"][1:]))
    t0 = min(got[r]["times"]["start"] for r in (0, 1))
    stamps = {k: max(got[r]["times"][k] for r in (0, 1)) - t_spawn
              for k in ("start", "ready", "go", "built", "trained", "held")}
    secs = t_trained - t_phase
    print(f"[tp] gemma2-2b full width, {cfg.n_layers} of 26 layers, fp32 compute (TF32 off), "
          f"TokenPipeline(vocab {cfg.vocab_size}, seq {TP_SEQ}, batch {TP_BATCH}, seed 0), "
          f"{TP_STEPS} AdamW steps at lr {TP_LR} constant: one process losses {ref['losses']} "
          f"grad norms {ref['grad_norms']}; two processes on cuda:0 over a (1, 2) mesh "
          f"(model axis: a gloo group; FSDP2's 1-rank data axis: gloo too; units split "
          f"{got[0]['split']}) losses {got[0]['losses']} grad norms {got[0]['grad_norms']} "
          f"(rank 1 {got[1]['losses']} {got[1]['grad_norms']})", flush=True)
    print(f"[tp] held on {TP_SAMPLES} seeded elements of each of {len(ref['leaves'])} leaves "
          f"({got[0]['compared']} + {got[1]['compared']} compared): worst gap / band "
          + ", ".join(f"{part} {max(got[r]['worst'][part][0] for r in (0, 1)):.3f}"
                      for part in "pmv")
          + f"; param elements past {TP_P_CLOSE}: {got[0]['far']} + {got[1]['far']} "
          f"({far_share:.2e}, gate {TP_P_FAR_SHARE}); the initial params (no update) would read "
          f"p {idle_ratio:.3f} of the band and {idle_far_share:.4f} past {TP_P_CLOSE}"
          f"; each leaf's fp64 sum: worst gap / band {worst_sum:.3e}; state bytes a rank "
          f"allocated {got[0]['allocated']} and {got[1]['allocated']} against the dry-run's "
          f"{predicted} on a 1 x 2 mesh ({abs(got[0]['allocated'] - predicted) / predicted:.2e} "
          f"apart, gate {ARG_GATE}); kernel launches {got[0]['launches']}", flush=True)
    print(f"[tp] step ms (median of steps 1-{TP_STEPS - 1}): one process {one_ms:.1f} "
          f"(peak {ref['peak_gb']:.2f} GB), two processes {tp_ms[0]:.1f} and {tp_ms[1]:.1f} "
          f"(peaks {got[0]['peak_gb']:.2f} and {got[1]['peak_gb']:.2f} GB a rank) -- gloo "
          f"through the host, which measures nothing of tensor parallelism over NVLink; "
          f"{card_line()}; seconds from the spawn: ranks started {stamps['start']:.1f}, ready "
          f"{stamps['ready']:.1f}, one-process run done {t_ref - t_spawn:.1f}, states built "
          f"{stamps['built']:.1f}, trained {stamps['trained']:.1f}, held {stamps['held']:.1f} "
          f"(first rank up {t0 - t_spawn:.1f}; phase 13b's baseline served in this process "
          f"{t_ref - t_spawn:.1f}-{t_sref - t_spawn:.1f}); phase 13 took {secs:.1f} s", flush=True)
    serve = tps_gates(sref, served, time.perf_counter() - t_trained, t_sref - t_ref)
    return {"ref": {k: ref[k] for k in ("losses", "grad_norms", "walls", "peak_gb")},
            "far_share": far_share, "idle_far_share": idle_far_share, "idle_ratio": idle_ratio,
            "ranks": {r: {k: v for k, v in res.items() if k != "sums"} for r, res in got.items()},
            "predicted": predicted, "tp_ms": tp_ms, "one_ms": one_ms, "seconds": secs,
            "serve": serve, "both_seconds": time.perf_counter() - t_phase}


def tps_gates(sref: dict, served: dict, rank_secs: float, base_secs: float) -> dict:
    """Phase 13b's gates on the ranks' reports against the one-process
    baseline ``sref``: each rank's logits at every step within
    TPS_LOGIT_REL of the step's max |logit|, its greedy tokens equal, its
    sampled cache within TPS_CACHE_REL; 26 decode_attention launches a
    decode step on each rank and in the baseline, no masked_l2_topk; the
    kernel equal to its plain version on each one's cache."""
    import numpy as np

    cfg = tps_config()
    steps = len(sref["walls"]) - 1
    want = {"masked_l2_topk": 0, "decode_attention": cfg.n_layers * steps}
    check(steps == TPS_NEW - 1 and sref["launches"] == want,
          f"[tp-serve] the baseline: {steps} decode steps, launches {sref['launches']}")
    for r, res in sorted(served.items()):
        check(res["steps"] == (steps + 1, steps + 1),
              f"[tp-serve] rank {r} served {res['steps'][0]} steps, the baseline {steps + 1}")
        check(res["tokens_equal"], f"[tp-serve] rank {r}'s greedy tokens differ from the "
                                   "one-process run's")
        check(res["logit_rel"] <= TPS_LOGIT_REL,
              f"[tp-serve] rank {r}'s logits {res['logit_rel']:.3e} of the max |logit| off")
        check(res["cache_rel"] <= TPS_CACHE_REL,
              f"[tp-serve] rank {r}'s sampled cache {res['cache_rel']:.3e} off")
        check(res["launches"] == want, f"[tp-serve] rank {r}'s launches {res['launches']}, "
                                       f"not {want}")
    one_pre, one_dec = sref["walls"][0], float(np.median(sref["walls"][1:]))
    tp_pre = [served[r]["walls"][0] for r in (0, 1)]
    tp_dec = [float(np.median(served[r]["walls"][1:])) for r in (0, 1)]
    secs = rank_secs + base_secs
    print(f"[tp-serve] gemma2-2b full width and all {cfg.n_layers} layers, fp32 (TF32 off), "
          f"{TPS_REQUESTS} requests of {sorted(len(p) for p in tps_prompts(cfg))} tokens, "
          f"{TPS_NEW} new, max_len {TPS_MAX_LEN}, ServeEngine in one batch; two ranks on cuda:0 "
          f"over the (1, 2) mesh (gloo), units split {served[0]['split']}, KV heads "
          f"{served[0]['kv_heads']} and {served[1]['kv_heads']} (start, count) of "
          f"{cfg.n_kv_heads}: logits {max(served[r]['logit_rel'] for r in (0, 1)):.3e} of the "
          f"max |logit| off the one-process run's (gate {TPS_LOGIT_REL}), greedy tokens equal, "
          f"sampled cache {max(served[r]['cache_rel'] for r in (0, 1)):.3e} off (gate "
          f"{TPS_CACHE_REL}); decode_attention launches {served[0]['launches']['decode_attention']}"
          f" and {served[1]['launches']['decode_attention']} a rank, "
          f"{sref['launches']['decode_attention']} in one process ({cfg.n_layers} x {steps} "
          f"steps), masked_l2_topk 0; kernel vs plain on each one's cache max_abs_err "
          f"{max(sref['cache_err'], *(served[r]['cache_err'] for r in (0, 1))):.3g}", flush=True)
    print(f"[tp-serve] prefill ms: one process {one_pre:.1f}, two ranks {tp_pre[0]:.1f} and "
          f"{tp_pre[1]:.1f}; decode ms a step (median of {steps}): one process {one_dec:.2f}, "
          f"two ranks {tp_dec[0]:.2f} and {tp_dec[1]:.2f} -- gloo through the host, not tensor "
          f"parallelism over NVLink; peak GB serving: one process {sref['peak_gb']:.2f}, a rank "
          f"{served[0]['peak_gb']:.2f} and {served[1]['peak_gb']:.2f} (building: "
          f"{sref['build_gb']:.2f}, {served[0]['build_gb']:.2f} and "
          f"{served[1]['build_gb']:.2f}: the whole model and init's fp32 draw of its largest "
          f"weight); {card_line()}; phase 13b "
          f"took {secs:.1f} s ({base_secs:.1f} s of baseline in this process while the ranks "
          f"started, {rank_secs:.1f} s on the ranks after phase 13)", flush=True)
    return {"launches": sref["launches"], "cache_err": max(
                sref["cache_err"], *(served[r]["cache_err"] for r in (0, 1))),
            "rank_launches": [served[r]["launches"]["decode_attention"] for r in (0, 1)],
            "one_prefill_ms": one_pre, "one_decode_ms": one_dec, "tp_prefill_ms": tp_pre,
            "tp_decode_ms": tp_dec, "peak_gb": [served[r]["peak_gb"] for r in (0, 1)],
            "one_peak_gb": sref["peak_gb"], "seconds": secs,
            "build_gb": [sref["build_gb"]] + [served[r]["build_gb"] for r in (0, 1)],
            "logit_rel": max(served[r]["logit_rel"] for r in (0, 1)),
            "cache_rel": max(served[r]["cache_rel"] for r in (0, 1))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2_140_000)
    ap.add_argument("--train", type=int, default=200)
    ap.add_argument("--serve", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    from repro_torch.device import strict_fp32

    strict_fp32()
    t_start = time.perf_counter()
    check_encdec_bound()
    build_kernels()
    kc = kernel_checks(2_140_000, 384)
    dc = decode_checks()
    wc = decode_window_checks()
    i8 = decode_int8_checks()
    fc = decode_frontend_checks()
    sc = decode_split_checks()
    mp = main_path(args.rows, args.train, args.serve, args.batch)
    real_row_independence(mp)
    dnf = dnf_phase(mp)
    rt = routed_phase(mp, dnf["unions"])
    del rt["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    lv = live_phase(mp)
    ru = runtime_phase(mp)
    lm = lm_serving(n_layers=QWEN_LAYERS)
    rag_phase(lm["model"], mp)
    del lm["model"], mp["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    served = {"6": lm}
    for phase, arch, kw in (
            ("6b", GEMMA, dict(plens=(4200, 8000), max_len=8192, tag="gemma2")),
            ("6c", OLMOE, dict(tag="olmoe")),
            # 4 profiled steps, not 8: a step of ~3,000 kernels and ~10,000
            # host ops makes the profiler's own processing most of a phase
            ("6d", HYMBA, dict(prompt_lens=RECURRENT_PROMPTS, tag="hymba",
                               teacher_forced=False, idle_steps=4)),
            ("6e", XLSTM, dict(prompt_lens=RECURRENT_PROMPTS, tag="xlstm",
                               teacher_forced=False, idle_steps=4)),
            # 6b's first 8 requests with the int8 cache
            ("6f", GEMMA, dict(plens=(4200, 8000), max_len=8192, tag="gemma2-int8", new=16,
                               n_serve=8, kv_cache_int8=True, teacher_forced=False,
                               idle_steps=4))):
        out = lm_serving(arch, **kw)
        del out["model"]
        gc.collect()
        torch.cuda.empty_cache()
        served[phase] = out
    int8_report(served["6b"], served["6f"])
    t_phase = time.perf_counter()
    fp32_exactness()
    # gemma2: prompts past its 4096 window; olmoe at the reference's reduced()
    # capacity factor 8, so that no token drops and a row's capacity does not
    # depend on its batch's padded length
    fp32_exactness(GEMMA, plens=(4100, 4600), tag="fp32b")
    fp32_exactness(OLMOE, tag="fp32b", capacity_factor=8.0)
    print(f"[fp32] phases 8 and 8b took {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    # 8c: hymba with layer 0 global and three 1,024 windows passed by 1,100
    # tokens; xlstm as one group (1 sLSTM + 7 mLSTM) over 600 tokens, no
    # multiple of the 256-step chunk; qwen3 with the int8 cache
    fp32_exactness(HYMBA, equal_len=1100, tag="fp32c")
    fp32_exactness(XLSTM, n_layers=8, equal_len=600, tag="fp32c")
    fp32_exactness(QWEN, tag="fp32c", teacher_forced=False, kv_cache_int8=True)
    secs_8c = time.perf_counter() - t_phase
    print(f"[fp32c] phase 8c took {secs_8c:.1f} s", flush=True)
    t_phase = time.perf_counter()
    served["12"] = frontend_serving(SEAMLESS, S12_REQUESTS, S12_SLOTS, S12_PLENS, S12_NEW,
                                    S12_MAX_LEN, tag="seamless")
    served["12b"] = frontend_serving(INTERNVL, I12_REQUESTS, I12_REQUESTS, I12_PLENS, I12_NEW,
                                     I12_MAX_LEN, tag="internvl2", n_layers=I12_LAYERS)
    frontend_fp32(SEAMLESS, 4, S12_PLENS)
    frontend_fp32(INTERNVL, 2, (64, 512))
    print(f"[frontend] phases 12, 12b and 12c took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    tr = train_phase()
    t_phase = time.perf_counter()
    cli_phase()
    print(f"[cli] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    served["11"] = qwen32_phase(tr)
    gc.collect()
    torch.cuda.empty_cache()
    tp = tp_phase()
    served["13b"] = tp["serve"]
    print(f"[smoke] phases 13 and 13b (tensor-parallel training and serving) took "
          f"{tp['both_seconds']:.1f} s (13 {tp['seconds']:.1f}, 13b {tp['serve']['seconds']:.1f})",
          flush=True)
    print(f"[smoke] phase 10 (training) took {tr['seconds']:.1f} s; the script "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    head = kc["rows"][(1, 2_140_000, 10)]
    b256 = kc["rows"][(256, 2_140_000, 10)]
    dhead = dc["rows"][(8, 2088, "bf16")]
    wrow, wcap = wc["rows"][("gemma2", 4096, 0.0)], wc["rows"][("gemma2", 4096, 50.0)]
    irow, iwin = i8["rows"][("qwen3", None, 0.0)], i8["rows"][("gemma2", 4096, 0.0)]
    ihym = i8["rows"][("hymba", 1024, 0.0)]
    kernels = [{
        "name": "masked_l2_topk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_l2_topk.cu",
        "replaces": "src/repro/kernels/masked_l2.py:33",
        "launches": sum(p["launches"]["masked_l2_topk"] for p in (mp, dnf, rt, lv, ru)),
        "max_abs_err": kc["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "train_launches": tr["launches"]["masked_l2_topk"],
        "shape": {"B": 1, "N": 2_140_000, "d": 384, "k": 10, "mask_pass": 0.5},
        "ms_b256": b256["ms"], "library_ms_b256": b256["library_ms"],
        "bound_ms_b256": b256["bound_ms"], "path_b256": b256["path"],
        "check": "ok",
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:29",
        "launches": (sum(p["launches"]["decode_attention"] for p in served.values())
                     + sum(tp["serve"]["rank_launches"])),
        "launches_by_phase": {k: p["launches"]["decode_attention"] for k, p in served.items()},
        "launches_13b_ranks": tp["serve"]["rank_launches"],
        "train_launches": tr["launches"]["decode_attention"],
        "max_abs_err": max(dc["max_abs_err"], wc["max_abs_err"], i8["max_abs_err"],
                           fc["max_abs_err"], sc["max_abs_err"],
                           *(p["cache_err"] for p in served.values())),
        "ms": dhead["ms"], "plain_ms": dhead["plain_ms"], "bound_ms": dhead["bound_ms"],
        "bound_by": dhead["bound_by"], "library_ms": dhead["library_ms"],
        "device_ms": dhead["device_ms"], "plain_device_ms": dhead["plain_device_ms"],
        "library_device_ms": dhead["library_device_ms"],
        "launches_per_call": dhead["launches_per_call"], "chunk": dhead["chunk"],
        "shape": {"B": 8, "KV": 8, "GQ": 5, "S": 2088, "dh": 128, "kv_dtype": "bf16",
                  "positions": sum(dhead["lengths"])},
        "window": {k: wrow[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                         "device_ms", "plain_device_ms", "library_device_ms",
                                         "max_abs_err")},
        "window_shape": {"B": 8, "KV": 4, "GQ": 2, "S": WINDOW_S, "dh": 256, "kv_dtype": "bf16",
                         "window": 4096, "softcap": 0.0, "positions": wrow["positions"]},
        "window_softcap": {k: wcap[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                "device_ms")},
        "int8": {**{k: irow[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                          "device_ms", "plain_device_ms", "library_device_ms",
                                          "bf16_ms", "bf16_device_ms", "max_abs_err")},
                 "library": "dequantize_kv of the whole cache + scaled_dot_product_attention "
                            "(two calls)",
                 "shape": {"B": 8, "KV": 8, "GQ": 5, "S": 2088, "dh": 128, "kv_dtype": "int8",
                           "dequant": "bf16", "positions": irow["positions"]},
                 "window": {k: iwin[k] for k in ("ms", "device_ms", "bound_ms", "library_ms",
                                                  "bf16_device_ms")},
                 "window_shape": {"B": 8, "KV": 4, "GQ": 2, "S": WINDOW_S, "dh": 256,
                                  "window": 4096, "softcap": 0.0,
                                  "positions": iwin["positions"]},
                 "hymba": {k: ihym[k] for k in ("ms", "device_ms", "bound_ms", "library_ms",
                                                 "bf16_device_ms")},
                 "hymba_shape": {"B": 8, "KV": 5, "GQ": 5, "S": 2088, "dh": 64, "window": 1024,
                                 "positions": ihym["positions"]}},
        "cross": {k: fc["rows"]["seamless-cross"][k] for k in (
            "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by", "max_abs_err", "shape")},
        "frontend_self": {t: {k: fc["rows"][t][k] for k in ("ms", "device_ms", "plain_ms",
                                                             "library_ms", "bound_ms", "shape")}
                          for t in ("seamless-self", "internvl2-self")},
        "split": {f"{name}_softcap{cap:g}": row for (name, cap), row in sc["rows"].items()},
        "split_shape": dict(zip(("B", "KV_cache", "KV", "GQ", "S", "dh", "window"), SPLIT_SHAPE),
                            kv0=SPLIT_SHAPE[1] - SPLIT_SHAPE[2],
                            positions=sc["rows"][("bf16", 0.0)]["positions"]),
        "check": "ok",
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
