#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing one line and exiting non-zero on failure:

1. environment: the card's name and power limit, torch/CUDA versions, and
   the seconds to build the CUDA kernels from ``flow_factory_tpu_torch/ops/csrc``;
2. kernels: K1 (fused qk-norm flash forward, CUDA C++), K5 (norm-modulate)
   and K6 (residual-gate-modulate, both Triton) against their plain PyTorch
   versions at the SD3.5-M shapes and a small ragged shape each, with
   stated tolerances and CUDA-event timings;
3. the slice at full width: SD3.5-M (random weights from a seed, bf16)
   through ``load_adapter`` → ``inference`` (2 prompts x group 4 = 8 samples,
   512 px, 10 steps, CFG 4.5, Flow-SDE with log-probs, decode) → brightness
   reward → group advantages → no-grad replay of every stored transition,
   whose ratio ``exp(new_lp - old_lp)`` must be exactly 1.0; then a
   torch.profiler breakdown of one replayed step (device time by kernel,
   idle share; the trace goes to ``chiprun_out/``).

The line before the last holds the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
Exits non-zero without a result when no CUDA device is visible or the
package is not beside the script.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 rate outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_environment():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    from flow_factory_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build("qknorm_flash_fwd")
    build_s = time.perf_counter() - t0
    log(f"[env] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | nvcc build {build_s:.2f} s")
    return card


def _check(name: str, err: float, tol: float) -> None:
    status = "ok" if err <= tol else "FAILED"
    log(f"[kernels] {name}: max|d| {err:.3e} (tol {tol:.3e}) {status}")
    if not err <= tol:
        fail(f"{name} disagrees with its plain version: {err} > {tol}")


def _k1_errors(out, lse, ref, ref_lse):
    return (out.float() - ref.float()).abs().max().item(), (lse - ref_lse).abs().max().item()


def _negative_control(name: str, kernel, wrong_ref, tol_o: float, tol_lse: float) -> None:
    """The K1 check must reject a reference that computes something else."""
    err_o, err_lse = _k1_errors(*kernel, *wrong_ref)
    caught = err_o > tol_o or err_lse > tol_lse
    log(f"[kernels] negative control, {name}: max|d| O {err_o:.3e} (tol {tol_o:.3e}), lse {err_lse:.3e} "
        f"(tol {tol_lse:.3e}) {'rejected as it must be' if caught else 'NOT REJECTED'}")
    if not caught:
        fail(f"the K1 check cannot tell the kernel from a wrong one: {name}")


def _record(results: dict, tag: str, entry: dict) -> None:
    """The first (largest) shape of a kernel is its entry; later shapes nest
    under ``shapes``."""
    first = results.setdefault(entry["name"], {**entry, "shape": tag, "shapes": {}})
    if first is not entry and first["shape"] != tag:
        first["shapes"][tag] = {k: entry[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}


def phase_kernels(results: dict) -> None:
    import torch
    import torch.nn.functional as F

    from flow_factory_tpu_torch.ops import attention as A
    from flow_factory_tpu_torch.ops import norms as N

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # ---- K1: fused qk-norm flash forward -------------------------------------
    # Tolerances. fp32 inputs differ from the plain version only by summation
    # order and exp2 vs exp: 1e-4 on O, 1e-3 on lse. bf16: after the RMS norm
    # q.k.D^-1/2 has a std of ~1, so O, a softmax-weighted mean of ~1000 V
    # rows, stays below ~0.5. The kernel rounds the normalised q once with
    # scale*log2(e) folded in, the plain version rounds it unscaled; that moves
    # logits by a fraction of a bf16 ulp and O by 1-2 ulp of max|O| (measured
    # on the card), so the bar is 4 ulp of max|O| on O and 1e-2 on lse
    # (measured <= 3e-3). Wrong kernels miss these bars: the negative controls
    # below compare the kernel with a plain version that ignores the gamma
    # maps, or drops the ragged key tail, and must FAIL the same check.
    # The self case has the head-split strided layout that SelfAttention
    # passes, (B, S, H, D).transpose(1, 2); the joint case is the contiguous
    # output of JointAttention's context/image concatenation.
    for tag, B, H, S, D, dtype, strided, timed in (
            ("joint", 16, 24, 1357, 64, torch.bfloat16, False, True),
            ("self", 16, 24, 1024, 64, torch.bfloat16, True, True),
            ("ragged-fp32", 2, 3, 197, 64, torch.float32, False, False),
            ("ragged-bf16", 2, 3, 77, 64, torch.bfloat16, True, False)):
        if strided:
            q, k, v = (randn(B, S, H, D, dtype=dtype).transpose(1, 2) for _ in range(3))
        else:
            q, k, v = (randn(B, H, S, D, dtype=dtype) for _ in range(3))
        gq = (1.0 + 0.1 * randn(S, D, dtype=torch.float32)).contiguous()
        gk = (1.0 + 0.1 * randn(S, D, dtype=torch.float32)).contiguous()
        scale = D ** -0.5
        out, lse = A.qknorm_flash_attention(q, k, v, gq, gk, scale, 1e-6, return_lse=True)
        ref, ref_lse = A.qknorm_attention_plain(q, k, v, gq, gk, scale, 1e-6, return_lse=True)
        torch.cuda.synchronize()
        tol_o, tol_lse = ((1e-4, 1e-3) if dtype == torch.float32
                          else (4 * bf16_ulp(ref.float().abs().max().item()), 1e-2))
        err_o, err_lse = _k1_errors(out, lse, ref, ref_lse)
        layout = "strided" if strided else "contiguous"
        _check(f"K1 {tag} O {tuple(q.shape)} {dtype} {layout}", err_o, tol_o)
        _check(f"K1 {tag} lse", err_lse, tol_lse)
        if tag == "joint":
            ones = torch.ones_like(gq)
            _negative_control("K1 joint vs a plain version without the gamma maps", (out, lse),
                              A.qknorm_attention_plain(q, k, v, ones, ones, scale, 1e-6, return_lse=True),
                              tol_o, tol_lse)
            n = S // 64 * 64  # the kernel's last whole key tile
            _negative_control(f"K1 joint vs a plain version without the {S - n}-key ragged tail", (out, lse),
                              A.qknorm_attention_plain(q, k[:, :, :n], v[:, :, :n], gq, gk[:n], scale, 1e-6,
                                                       return_lse=True), tol_o, tol_lse)
        if not timed:
            continue
        ms = time_ms(lambda: A.qknorm_flash_attention(q, k, v, gq, gk, scale, 1e-6))
        plain_ms = time_ms(lambda: A.qknorm_attention_plain(q, k, v, gq, gk, scale, 1e-6), iters=3)
        qn = A._rms_scale(q, gq, 1e-6).to(dtype)
        kn = A._rms_scale(k, gk, 1e-6).to(dtype)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qn, kn, v, scale=scale))
        flops = A.attention_flops(B, H, S, S, D)
        byts = nbytes(q, k, v, gq, gk, out, lse)
        bound = max(flops / PEAK_BF16_FLOPS, byts / PEAK_BYTES) * 1e3
        _record(results, tag, dict(
            name="qknorm_flash_fwd", route="cuda",
            source="flow_factory_tpu_torch/ops/csrc/qknorm_flash_fwd.cu",
            replaces="flow_factory_tpu/ops/attention.py:368",
            max_abs_err=err_o, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by="operations" if flops / PEAK_BF16_FLOPS > byts / PEAK_BYTES else "bytes",
            library_ms=lib_ms))
        log(f"[kernels] K1 {tag}: kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | sdpa {lib_ms:.3f} ms"
            f" | bound {bound:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
        del q, k, v, out, ref, qn, kn
        torch.cuda.empty_cache()

    # ---- K5: LayerNorm/RMSNorm + modulate ------------------------------------
    # Tolerance: both compute fp32 stats (different summation order) and round
    # once to the output type: one bf16 ulp at the largest output, 1e-5
    # relative in fp32.
    for tag, B, S, D, dtype, per_token, fold, rms, timed in (
            ("image", 16, 1024, 1536, torch.bfloat16, False, False, False, True),
            ("context", 16, 333, 1536, torch.bfloat16, False, False, False, True),
            ("ragged-fold", 3, 77, 200, torch.float32, False, True, False, False),
            ("ragged-rms-token", 3, 77, 200, torch.float32, True, False, True, False),
            ("ragged-bf16-token", 2, 45, 1536, torch.bfloat16, True, False, False, False)):
        x = randn(B, S, D, dtype=dtype)
        mshape = (B, S if per_token else 1, D)
        mul = (1.0 + 0.1 * randn(*mshape, dtype=torch.float32)).contiguous()
        add = (0.1 * randn(*mshape, dtype=torch.float32)).contiguous()
        out = N.ln_mul_add(x, mul, add, 1e-6, dtype, fold=fold, rms=rms)
        ref = N._native_ln_mul_add(x, mul, add, 1e-6, dtype, fold, rms)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        _check(f"K5 {tag} {tuple(x.shape)} {dtype}", err,
               bf16_ulp(mag) if dtype == torch.bfloat16 else 1e-5 * max(1.0, mag))
        if not timed:
            continue
        ms = time_ms(lambda: N.ln_mul_add(x, mul, add, 1e-6, dtype, fold=False))
        plain_ms = time_ms(lambda: N._native_ln_mul_add(x, mul, add, 1e-6, dtype, False))
        byts = nbytes(x, mul, add, out)
        bound = max(byts / PEAK_BYTES, 10 * x.numel() / PEAK_FP32_FLOPS) * 1e3
        _record(results, tag, dict(
            name="ln_mul_add", route="triton", source="flow_factory_tpu_torch/ops/norms.py",
            replaces="flow_factory_tpu/ops/norms.py:93", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by="bytes", library_ms=None))
        log(f"[kernels] K5 {tag}: kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | bound "
            f"{bound:.4f} ms ({byts / ms / 1e6:.0f} GB/s)")

    # ---- K6: residual + gate + modulate --------------------------------------
    # Tolerance: x_new rounds exactly where eager PyTorch rounds (bf16: 0);
    # x_mod as K5.
    for tag, B, S, D, dtype, timed in (
            ("image", 16, 1024, 1536, torch.bfloat16, True),
            ("context", 16, 333, 1536, torch.bfloat16, True),
            ("ragged-fp32", 3, 77, 200, torch.float32, False),
            ("ragged-bf16", 2, 45, 1536, torch.bfloat16, False)):
        x, br = randn(B, S, D, dtype=dtype), randn(B, S, D, dtype=dtype)
        gate = randn(B, D, dtype=torch.float32)
        mul = (1.0 + 0.1 * randn(B, 1, D, dtype=torch.float32)).contiguous()
        add = (0.1 * randn(B, 1, D, dtype=torch.float32)).contiguous()
        xn, xm = N.residual_gate_modulate_rows(x, br, gate, mul, add, 1e-6, dtype)
        rn, rm = N._native_residual_gate_modulate(x, br, gate, mul, add, 1e-6, dtype)
        torch.cuda.synchronize()
        err_n = (xn.float() - rn.float()).abs().max().item()
        err_m = (xm.float() - rm.float()).abs().max().item()
        mag_n, mag_m = rn.float().abs().max().item(), rm.float().abs().max().item()
        _check(f"K6 {tag} x_new {tuple(x.shape)} {dtype}", err_n,
               0.0 if dtype == torch.bfloat16 else 1e-6 * max(1.0, mag_n))
        _check(f"K6 {tag} x_mod", err_m, bf16_ulp(mag_m) if dtype == torch.bfloat16 else 1e-5 * max(1.0, mag_m))
        if not timed:
            continue
        ms = time_ms(lambda: N.residual_gate_modulate_rows(x, br, gate, mul, add, 1e-6, dtype))
        plain_ms = time_ms(lambda: N._native_residual_gate_modulate(x, br, gate, mul, add, 1e-6, dtype))
        byts = nbytes(x, br, gate, mul, add, xn, xm)
        bound = max(byts / PEAK_BYTES, 12 * x.numel() / PEAK_FP32_FLOPS) * 1e3
        _record(results, tag, dict(
            name="residual_gate_modulate", route="triton",
            source="flow_factory_tpu_torch/ops/norms.py", replaces="flow_factory_tpu/ops/norms.py:300",
            max_abs_err=max(err_n, err_m), ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by="bytes", library_ms=None))
        log(f"[kernels] K6 {tag}: kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | bound "
            f"{bound:.4f} ms ({byts / ms / 1e6:.0f} GB/s)")
    torch.cuda.empty_cache()


def _config():
    from flow_factory_tpu_torch.hparams import Arguments

    # the SD3.5-M GRPO workload (tests/fixtures/sd35_grpo.yaml) cut to
    # 2 prompts x group 4 and random weights
    return Arguments.from_dict({
        "data": {"dataset_dir": "tests/fixtures/tiny_prompts"},
        "model": {"model_type": "sd3-5", "model_name_or_path": "", "variant": "medium",
                  "attn_backend": "auto", "master_dtype": "float32", "inference_dtype": "bfloat16"},
        "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.8, "num_sde_steps": 2,
                      "sde_steps": [1, 2, 3, 4, 5], "seed": 42},
        "train": {"trainer_type": "grpo", "advantage_aggregation": "sum", "global_std": True,
                  "resolution": 512, "num_inference_steps": 10, "guidance_scale": 4.5,
                  "per_device_batch_size": 8, "group_size": 4, "unique_sample_num_per_epoch": 2,
                  "latent_storage_dtype": "fp16", "seed": 42},
        "eval": {}, "log": {},
        "rewards": [{"name": "brightness", "reward_model": "MyReward", "batch_size": 8}],
    })


def phase_slice() -> dict:
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.advantage import AdvantageProcessor
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.rewards import RewardProcessor, load_reward_models

    cfg = _config()
    ta = cfg.training_args
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests/fixtures/tiny_prompts/train.txt")) as f:
        prompts = [line.strip() for line in f if line.strip()][:2]
    batch = [p for p in prompts for _ in range(ta.group_size)]
    secs = {}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adapter = load_adapter(cfg)  # cuda
    torch.cuda.synchronize()
    secs["load_adapter"] = time.perf_counter() - t0
    tcfg = adapter.component_configs["transformer"]
    log(f"[slice] SD3.5-M loaded: hidden {tcfg.hidden_dim}, depth {tcfg.depth}, heads {tcfg.num_heads}, "
        f"dual blocks {len(tcfg.dual_attention_layers)}, params "
        f"{sum(p.numel() for m in adapter.modules.values() for p in m.parameters()) / 1e9:.2f} B "
        f"in {secs['load_adapter']:.1f} s")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    enc = adapter.encode_prompt(batch)
    neg = adapter.encode_prompt([""] * len(batch))
    torch.cuda.synchronize()
    secs["encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples = adapter.inference(
        prompt=batch, prompt_embeds=enc["prompt_embeds"], pooled_prompt_embeds=enc["pooled_prompt_embeds"],
        negative_prompt_embeds=neg["prompt_embeds"], negative_pooled_prompt_embeds=neg["pooled_prompt_embeds"],
        height=512, width=512, num_inference_steps=10, guidance_scale=4.5, compute_log_prob=True,
        trajectory_indices="all", seed=ta.seed, decode=True)
    torch.cuda.synchronize()
    secs["rollout+decode"] = time.perf_counter() - t0
    rollout_counts = ops.launch_counts()

    t0 = time.perf_counter()
    reward_models = load_reward_models(cfg.reward_args)
    RewardProcessor(reward_models, cfg.reward_args.reward_weights).score_and_attach(samples)
    metrics = AdvantageProcessor(
        group_size=ta.group_size, aggregation=ta.advantage_aggregation,
        std_mode="global" if ta.global_std else "per_group",
        reward_weights=cfg.reward_args.reward_weights).compute_advantages(samples)
    secs["reward+advantage"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    new_lp = adapter.replay_log_probs(samples)
    torch.cuda.synchronize()
    secs["replay"] = time.perf_counter() - t0
    counts = ops.launch_counts()

    old = np.stack([s.log_probs for s in samples], axis=1)  # (T, B)
    sde_steps = [int(i) for i in np.nonzero(samples[0].extra_kwargs["noise_levels"])[0]]
    ratios = {i: np.exp(lp.double().cpu().numpy() - old[i].astype(np.float64)) for i, lp in new_lp.items()}
    bad = {i: r.tolist() for i, r in ratios.items() if not np.all(r == 1.0)}
    images = np.stack([s.image for s in samples])
    rewards = np.asarray([s.extra_kwargs["reward"] for s in samples])
    advantages = np.asarray([s.extra_kwargs["advantage"] for s in samples])
    log(f"[slice] images {images.shape} range [{images.min():.3f}, {images.max():.3f}] | rewards "
        f"{np.round(rewards, 4).tolist()} | advantages {np.round(advantages, 3).tolist()}")
    log(f"[slice] replayed steps {sorted(new_lp)} (SDE steps {sde_steps}); ratio==1.0 exactly on "
        f"{len(ratios) - len(bad)}/{len(ratios)}; old lp at SDE steps "
        f"{np.round(old[sde_steps].mean(axis=1), 4).tolist()}")
    if len(images) != 8 or images.shape[1:] != (3, 512, 512):
        fail(f"unexpected image batch {images.shape}")
    for name, arr in (("images", images), ("log-probs", old), ("rewards", rewards), ("advantages", advantages)):
        if not np.all(np.isfinite(arr)):
            fail(f"non-finite {name}")
    if bad or not ratios:
        fail(f"replay ratio != 1.0 at steps {sorted(bad)}: {bad}")
    if any(counts[name] <= 0 for name in counts):
        fail(f"a kernel of the path never launched: {counts}")
    phase_profile(adapter, samples, sde_steps[0])
    samples_per_s = len(samples) / secs["rollout+decode"]
    log(f"[slice] launches rollout {rollout_counts} | rollout+replay {counts}")
    log(f"[slice] phase seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})} | "
        f"{samples_per_s:.3f} samples/s (rollout+decode) | peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | advantage/std {metrics['advantage/std']:.4f}")
    return counts


def phase_profile(adapter, samples, step: int) -> None:
    """torch.profiler over one replayed step (the CFG-doubled transformer
    forward plus the SDE step, as in the rollout): device time by kernel and
    the device's idle share of the wall time. The trace goes to
    chiprun_out/replay_step_trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    adapter.replay_log_probs(samples, steps=[step])  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        adapter.replay_log_probs(samples, steps=[step])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    busy_ms = sum(dev(e) for e in kernels)
    log(f"[profile] one replay step: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=dev, reverse=True)[:12]:
        log(f"[profile]   {dev(e):9.3f} ms {100 * dev(e) / busy_ms:5.1f}% x{e.count:<4d} {e.key[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", "replay_step_trace.json"))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        import flow_factory_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the flow_factory_tpu_torch package is not beside this script: {e}", file=sys.stderr)
        return 2
    # fp32 convolutions (the VAE's last conv) run in full fp32, as the JAX reference does
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = phase_environment()
    results: dict = {}
    phase_kernels(results)
    counts = phase_slice()
    kernels = [{**entry, "launches": counts[name]} for name, entry in results.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
