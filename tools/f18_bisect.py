"""F18's bisection: which op of a transformer makes a row's bits depend on
how many rows stand beside it.

    python3 tools/f18_bisect.py [B N [TAG ...]]

runs, on the card, one forward of each full-width transformer below (random
bf16 weights) at batch ``B`` (default 8) and one on its first ``N`` rows
(default 4) alone, and prints the first module whose output's first ``N``
rows differ between the two, then every product (each ``F.linear`` on a
(batch, tokens, features) input, each leaf module) whose first ``N`` rows
differ, by its M, N, K and dtype. TAGs pick transformers (default all:
klein, sd35-medium, ltx2, a14b, ti2v-5b, wan21-i2v-14b, z-image,
qwen-image). ``chip_smoke.py`` calls :func:`bisect` on its own Wan2.1-I2V
transformer.

The port is imported from the checkout this file lies in; to bisect another
commit, copy this file into a ``git archive`` of it. A batch-invariant port
prints "every product checked gives its first N rows the same bits".
Prints no result line and exits 0 unless the card or the port is missing.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(msg, flush=True)


def _models(gen, B: int):
    """Each transformer and its inputs at batch ``B``, built on demand:
    FLUX.2-Klein (8 + 24 blocks at width 3072; 1024 image and 512 text
    tokens, guidance embedded), SD3.5-M (512 px, 333 text tokens, the pooled
    vector), LTX-2 (28 blocks; 128 video, 9 audio and 512 text tokens), the
    A14B (8 layers; 512 tokens), TI2V-5B (320 tokens at per-frame t, frame 0
    at 0), Wan2.1-I2V-14B (8 layers; 512 tokens of 33 channels, 257 CLIP
    tokens through the image stream), Z-Image (38 layers; 1024 + 512 tokens) and Qwen-Image (24 double
    blocks; 1024 + 512 tokens)."""
    import torch

    from flow_factory_tpu_torch.models.flux import flux2 as F2
    from flow_factory_tpu_torch.models.flux.transformer import FluxTransformer
    from flow_factory_tpu_torch.models.layers import build_module
    from flow_factory_tpu_torch.models.ltx2 import t2av as LT
    from flow_factory_tpu_torch.models.ltx2.transformer import LTX2Transformer
    from flow_factory_tpu_torch.models.qwen_image import adapter as QI
    from flow_factory_tpu_torch.models.sd3 import adapter as SD
    from flow_factory_tpu_torch.models.sd3.transformer import SD3Transformer
    from flow_factory_tpu_torch.models.wan import t2v as WT
    from flow_factory_tpu_torch.models.wan.transformer import WanTransformer
    from flow_factory_tpu_torch.models.z_image import adapter as ZI
    from flow_factory_tpu_torch.models.z_image.transformer import ZImageTransformer

    dev = torch.device("cuda")
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    t = torch.linspace(980.0, 120.0, B, device=dev)
    grid = lambda f, h, w: torch.stack(torch.meshgrid(torch.arange(float(f)), torch.arange(float(h)),
                                                      torch.arange(float(w)), indexing="ij"), -1).reshape(-1, 3).to(dev)
    build = lambda cls, cfg: build_module(lambda: cls(cfg), dev, torch.bfloat16, gen)
    args = ("auto", "bfloat16")
    no_text_ids = lambda: torch.zeros(512, 3, device=dev)

    def klein():
        cfg = F2._preset("klein", *args)["transformer"]
        return build(FluxTransformer, cfg), (randn(B, 1024, 64), t, randn(B, 512, cfg.context_dim), None,
                                             grid(1, 32, 32), no_text_ids(), torch.full((B,), 3.5, device=dev))

    def sd35():
        cfg = SD._preset("medium", *args)["transformer"]
        return build(SD3Transformer, cfg), (randn(B, 64, 64, 16), t, randn(B, 333, 4096), randn(B, 2048))

    def ltx2():
        p = LT._preset("ltx2", *args)
        cfg = dataclasses.replace(p["transformer"], context_dim=p["lm"].hidden_dim)
        return build(LTX2Transformer, cfg), (randn(B, 128, 128), randn(B, 9, 128), t, randn(B, 512, cfg.context_dim),
                                             torch.from_numpy(LT.LTX2T2AVAdapter._video_ids(2, 8, 8)).to(dev),
                                             torch.from_numpy(LT.LTX2T2AVAdapter._audio_ids(9, 2)).to(dev))

    def a14b():
        cfg = dataclasses.replace(WT._preset("wan2.2-a14b", *args)["transformer"], num_layers=8)
        return build(WanTransformer, cfg), (randn(B, 2, 32, 32, 16), t, randn(B, 512, 4096))

    def wan21_i2v():
        cfg = dataclasses.replace(WT._preset("14b", *args)["transformer"], num_layers=8, in_channels=33,
                                  image_context_tokens=257, image_context_dim=1280)
        return build(WanTransformer, cfg), (randn(B, 2, 32, 32, 33), t, randn(B, 512, 4096), randn(B, 257, 1280))

    def ti2v():
        cfg = WT._preset("wan2.2-ti2v-5b", *args)["transformer"]
        tf = t[:, None] * torch.tensor([0.0, 1, 1, 1, 1], device=dev)
        return build(WanTransformer, cfg), (randn(B, 5, 16, 16, 48), tf, randn(B, 512, 4096))

    def z_image():
        cfg = ZI._preset("z-image", *args)["transformer"]
        return build(ZImageTransformer, cfg), (randn(B, 1024, 64), t, randn(B, 512, cfg.context_dim),
                                               grid(1, 32, 32), no_text_ids())

    def qwen_image():
        cfg = dataclasses.replace(QI._preset("qwen-image", *args)["transformer"], num_double_blocks=24)
        return build(FluxTransformer, cfg), (randn(B, 1024, 64), t, randn(B, 512, cfg.context_dim), None,
                                             grid(1, 32, 32), no_text_ids())

    return {"klein": klein, "sd35-medium": sd35, "ltx2": ltx2, "a14b": a14b, "ti2v-5b": ti2v,
            "wan21-i2v-14b": wan21_i2v, "z-image": z_image, "qwen-image": qwen_image}


def _rows(x, n: int, batch: int):
    """The first ``n`` rows of every tensor of ``x`` that leads with the batch."""
    import torch

    if isinstance(x, torch.Tensor):
        return x[:n] if x.ndim and x.shape[0] == batch else x
    if isinstance(x, (tuple, list)):
        return type(x)(_rows(v, n, batch) for v in x)
    return x


def _tensors(x) -> list:
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def bisect(tag: str, model, inputs, B: int, n: int):
    """One forward on ``inputs`` (batch ``B``) and one on their first ``n``
    rows; forward hooks name the first module, in the order the modules
    finish, whose output's first ``n`` rows differ; a torch function mode
    and leaf-module hooks re-run each product of the batch-``B`` forward on
    its first ``n`` rows alone and count those that differ. Returns (the
    output's first ``n`` rows the same bits, {batch-variant product: calls})."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    names = {m: name or "<root>" for name, m in model.named_modules()}
    alone: dict = {}
    first: list = []
    varying: dict = {}
    busy = [False]  # inside a check's own re-run: nothing is recorded or checked

    def note(key: str) -> None:
        varying[key] = varying.get(key, 0) + 1

    def store(m, args, out):
        alone.setdefault(m, []).append(([t.clone() for t in _tensors(args)], [t.clone() for t in _tensors(out)]))

    def compare(m, args, out):
        if busy[0]:
            return
        a_in, a_out = alone[m].pop(0)
        got_in = [_rows(t, n, B) for t in _tensors(args)]
        pairs = [(x, y) for x, y in zip((_rows(t, n, B) for t in _tensors(out)), a_out) if x.shape == y.shape]
        if first or not pairs or all(torch.equal(x, y) for x, y in pairs):
            return
        same_in = len(got_in) == len(a_in) and all(torch.equal(x, y) for x, y in zip(got_in, a_in))
        diff = max(float((x.float() - y.float()).abs().max()) for x, y in pairs)
        shape = ""
        if isinstance(m, torch.nn.Linear):
            shape = f" (M {got_in[0].numel() // m.in_features} at B {n}, N {m.out_features}, K {m.in_features})"
        first.append(f"{names[m]} [{type(m).__name__}]{shape}: its first {n} rows differ by up to {diff!r}; its "
                     f"inputs the same bits: {same_in}")

    def module_check(m, args, out):
        x = args[0] if args else None
        if busy[0] or not (isinstance(x, torch.Tensor) and x.ndim >= 2 and x.shape[0] == B):
            return
        busy[0] = True
        try:
            ref = [_rows(t, n, B) for t in _tensors(out)]
            if not all(torch.equal(a, b) for a, b in zip(_tensors(m(*_rows(args, n, B))), ref)):
                shape = (f", N {m.out_features}, K {m.in_features}" if isinstance(m, torch.nn.Linear)
                         else f", input {tuple(x.shape)} {x.dtype}")
                note(f"{type(m).__name__} {names[m]} M {x.numel() // x.shape[-1]} (B {B}){shape}")
        finally:
            busy[0] = False

    class LinearCheck(TorchFunctionMode):
        # a 2-D product is a module's, checked as the module
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            x = args[0] if args else None
            if func is F.linear and not busy[0] and x.ndim >= 3 and x.shape[0] == B:
                w = args[1]
                if not torch.equal(func(x[:n], *args[1:], **(kwargs or {})), out[:n]):
                    M = x.numel() // x.shape[-1]
                    note(f"F.linear M {M} (B {B}) / {M // B * n} (B {n}), N {w.shape[0]}, K {w.shape[1]}, {x.dtype}")
            return out

    with torch.no_grad():
        hooks = [m.register_forward_hook(store) for m in model.modules()]
        try:
            out_n = model(*_rows(inputs, n, B))
        finally:
            for h in hooks:
                h.remove()
        hooks = [m.register_forward_hook(compare) for m in model.modules()]
        hooks += [m.register_forward_hook(module_check) for m in model.modules() if not list(m.children())]
        try:
            with LinearCheck():
                out_b = model(*inputs)
        finally:
            for h in hooks:
                h.remove()
    same = all(torch.equal(a[:n], b) for a, b in zip(_tensors(out_b), _tensors(out_n)))
    log(f"[f18] {tag}: the output's first {n} rows the same bits at B {B} as alone: {same}; the first module "
        f"to differ: {first[0] if first else 'none'}")
    for key, count in sorted(varying.items()):
        log(f"[f18] {tag}: batch-variant product: {key} ({count} calls)")
    if not varying:
        log(f"[f18] {tag}: every product checked gives its first {n} rows the same bits at B {B} as alone")
    return same, varying


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from flow_factory_tpu_torch.ops import cuda_build
    from flow_factory_tpu_torch.utils.base import use_full_fp32

    B, n = (int(a) for a in (sys.argv[1:3] if len(sys.argv) >= 3 else (8, 4)))
    tags = set(sys.argv[3:])
    use_full_fp32()
    for name in ("flash_fwd", "qknorm_flash_fwd"):
        cuda_build.build(name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"[f18] port at {ROOT}, rows 0-{n - 1} of a batch of {B} | card {smi.stdout.strip() or 'unknown'}")
    gen = torch.Generator(device="cuda").manual_seed(18)
    for tag, make in _models(gen, B).items():
        if tags and tag not in tags:
            continue
        model, inputs = make()
        bisect(tag, model, inputs, B, n)
        del model, inputs
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
