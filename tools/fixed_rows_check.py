"""What F18's fixed row counts cost, and whether one batched product could
replace their loop of products, at the port's shapes on the card.

    python3 tools/fixed_rows_check.py

For each product that ``models/layers.py`` runs at a fixed row count (the
AdaLN modulation at ``SAMPLE_ROWS``, LTX-2's audio FFN at
``FEW_TOKEN_ROWS``, the fp32 heads at ``HEAD_ROWS``), at the row counts M
that the rollouts and grad steps give it: whether ``fixed_rows_linear``
(one product a chunk) gives the first chunk's rows the same bits at every
M, whether one batched product over the chunks (``torch.baddbmm`` on an
(M / rows, rows, K) view, the weight broadcast) does too and equals the
loop's bits; then the CUDA-event milliseconds of ``F.linear`` on all M rows
at once (not batch-invariant), of the loop and of the batched product at
the largest M. Prints no result line.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: (name, rows, K, N, dtype, the row counts M of the path: batch x tokens a sample)
SHAPES = (
    ("AdaLN modulation (Klein/FLUX)", "SAMPLE_ROWS", 3072, 18432, "float32", (1, 2, 3, 4, 5, 8, 16)),
    ("AdaLN modulation (SD3.5-M)", "SAMPLE_ROWS", 1536, 9216, "float32", (1, 2, 3, 4, 5, 8, 16)),
    ("LTX-2 audio FFN down", "FEW_TOKEN_ROWS", 8192, 2048, "bfloat16", tuple(9 * b for b in (1, 2, 4, 5, 8, 16))),
    ("SD3.5-M head", "HEAD_ROWS", 1536, 64, "float32", tuple(4096 * b for b in (1, 2, 3, 4, 5, 8, 16))),
    ("A14B head", "HEAD_ROWS", 5120, 64, "float32", tuple(512 * b for b in (1, 2, 4, 5, 8, 16))),
    ("FLUX/Qwen head", "HEAD_ROWS", 3072, 64, "float32", tuple(1024 * b for b in (1, 2, 4, 5, 8, 16))),
    ("LTX-2 video head", "HEAD_ROWS", 2048, 128, "float32", tuple(128 * b for b in (1, 2, 4, 5, 8, 16))),
)


def batched_rows_linear(x, weight, bias, rows: int):
    """One ``baddbmm`` over ``x``'s rows zero-padded and viewed as (M / rows,
    rows, K), the weight (and bias) broadcast over the chunks."""
    import torch
    import torch.nn.functional as F

    M, K = x.shape
    x3 = F.pad(x, (0, 0, 0, -M % rows)).view(-1, rows, K)
    wt = weight.t().expand(x3.shape[0], K, weight.shape[0])
    out = torch.baddbmm(bias.expand(x3.shape[0], rows, -1), x3, wt)
    return out.reshape(-1, weight.shape[0])[:M]


def event_ms(fn, iters: int = 20, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from flow_factory_tpu_torch.models import layers
    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[rows] {smi.stdout.strip() or 'unknown'} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, rows_name, K, N, dtype, Ms in SHAPES:
        rows, dt = getattr(layers, rows_name), getattr(torch, dtype)
        x_all = torch.randn(max(Ms), K, generator=gen, device="cuda").to(dt)
        w = (torch.randn(N, K, generator=gen, device="cuda") / K ** 0.5).to(dt)
        b = torch.randn(N, generator=gen, device="cuda").to(dt)
        first = min(rows, min(Ms))
        loop = {M: layers.fixed_rows_linear(x_all[:M], w, b, rows)[:first] for M in Ms}
        batched = {M: batched_rows_linear(x_all[:M], w, b, rows)[:first] for M in Ms}
        plain = {M: F.linear(x_all[:M], w, b)[:first] for M in Ms}
        same = lambda outs: all(torch.equal(o, outs[Ms[0]]) for o in outs.values())
        M = max(Ms)
        x = x_all[:M]
        ms = {"F.linear": event_ms(lambda: F.linear(x, w, b)),
              "loop": event_ms(lambda: layers.fixed_rows_linear(x, w, b, rows)),
              "batched": event_ms(lambda: batched_rows_linear(x, w, b, rows))}
        print(f"[rows] {name}: {rows_name} {rows}, K {K}, N {N}, {dtype}, M {list(Ms)}: the first {first} rows' "
              f"bits the same at every M: loop {same(loop)}, batched {same(batched)} (equal to the loop's: "
              f"{all(torch.equal(batched[m], loop[m]) for m in Ms)}), F.linear {same(plain)}; ms at M {M} "
              f"({-(-M // rows)} chunks): " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
