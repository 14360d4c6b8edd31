"""PyTorch port, F18 on the CPU: a replay at another micro-batch size than
the rollout's must give each row the rollout's bits. A GEMM library picks its
kernel by the product's shape, so the fp32 products whose rows are the batch
itself (the time, guidance and pooled-text embedders, every AdaLN
modulation of the time embedding) run at a fixed row count
(``layers.Linear(..., rows=SAMPLE_ROWS)``) whatever the batch, and so
do LTX-2's audio stream (``FEW_TOKEN_ROWS``) and every fp32 output head
(``HEAD_ROWS``); each row's log-prob is reduced on its own.

For one tiny transformer of each ported family (SD3, FLUX with its pooled
vector and FLUX.2 with guidance, Qwen-Image's FLUX without single blocks,
Wan at per-sample and per-frame t, LTX-2, Z-Image), one forward at batch 3
and one at batch 5, every ``F.linear`` recorded: each product either runs
at the same row count in both (one of the fixed counts) or has M = batch x
a token count of at least ``MIN_TOKENS`` rows a sample; and rows 0-2 of the
batch of 5 equal the batch of 3 bit for bit."""
import pytest
import torch
import torch.nn.functional as F
from torch_port_threads import one_torch_thread  # noqa: F401

from flow_factory_tpu_torch.models import layers
from flow_factory_tpu_torch.models.layers import (FEW_TOKEN_ROWS, HEAD_ROWS, SAMPLE_ROWS, build_module,
                                                  fixed_rows_linear)

#: the fewest tokens a sample of the tiny models below carries in any stream
MIN_TOKENS = 8


def _ids(n):
    ids = torch.zeros(n, 3)
    ids[:, 2] = torch.arange(float(n))
    return ids


def _sd3(gen, B):
    from flow_factory_tpu_torch.models.sd3.transformer import MMDiTConfig, SD3Transformer

    model = SD3Transformer(MMDiTConfig.tiny())
    return model, lambda g: (torch.randn(B, 8, 8, 16, generator=g), torch.linspace(950.0, 50.0, B),
                             torch.randn(B, 12, 32, generator=g), torch.randn(B, 48, generator=g))


def _flux(cfg_kw, guidance):
    def make(gen, B):
        from flow_factory_tpu_torch.models.flux.transformer import FluxConfig, FluxTransformer

        cfg = FluxConfig.tiny(**cfg_kw)
        model = FluxTransformer(cfg)
        return model, lambda g: (torch.randn(B, 16, 16, generator=g), torch.linspace(950.0, 50.0, B),
                                 torch.randn(B, 12, cfg.context_dim, generator=g),
                                 torch.randn(B, cfg.pooled_dim, generator=g) if cfg.pooled_dim else None,
                                 _ids(16), _ids(12), torch.full((B,), 3.5) if guidance else None)
    return make


def _wan(per_frame):
    def make(gen, B):
        from flow_factory_tpu_torch.models.wan.transformer import WanConfig, WanTransformer

        model = WanTransformer(WanConfig.tiny())

        def inputs(g):
            t = torch.linspace(950.0, 50.0, B)
            if per_frame:
                t = torch.stack([torch.zeros(B), t, t], dim=1)
            return torch.randn(B, 3, 8, 8, 16, generator=g), t, torch.randn(B, 12, 48, generator=g)
        return model, inputs
    return make


def _ltx2(gen, B):
    from flow_factory_tpu_torch.models.ltx2.transformer import LTX2Config, LTX2Transformer

    model = LTX2Transformer(LTX2Config.tiny())
    vid = torch.stack(torch.meshgrid(torch.arange(2.0), torch.arange(4.0), torch.arange(4.0), indexing="ij"),
                      -1).reshape(-1, 3)
    return model, lambda g: (torch.randn(B, 32, 16, generator=g), torch.randn(B, 9, 8, generator=g),
                             torch.linspace(950.0, 50.0, B), torch.randn(B, 12, 32, generator=g), vid, _ids(9))


def _z_image(gen, B):
    from flow_factory_tpu_torch.models.z_image.transformer import ZImageConfig, ZImageTransformer

    model = ZImageTransformer(ZImageConfig.tiny())
    return model, lambda g: (torch.randn(B, 16, 16, generator=g), torch.linspace(950.0, 50.0, B),
                             torch.randn(B, 12, 32, generator=g), _ids(16), _ids(12))


FAMILIES = {
    "sd3": _sd3,
    "flux-pooled": _flux({}, False),
    "flux2-guidance": _flux({"pooled_dim": 0, "guidance_embeds": True}, True),
    "qwen-image": _flux({"pooled_dim": 0, "txt_norm": True, "num_single_blocks": 0}, False),
    "wan": _wan(False),
    "wan-per-frame": _wan(True),
    "ltx2": _ltx2,
    "z-image": _z_image,
}


def _forward(name, B, monkeypatch):
    """The family's tiny transformer (fixed random init) on the first ``B``
    rows of a fixed batch of 5: (output tensors, [(M, N, K) of every
    F.linear in call order])."""
    gen = torch.Generator().manual_seed(18)
    model, inputs = FAMILIES[name](gen, 5)
    model = build_module(lambda: model, torch.device("cpu"), torch.float32, gen)
    args = [a[:B] if isinstance(a, torch.Tensor) and a.ndim and a.shape[0] == 5 else a
            for a in inputs(torch.Generator().manual_seed(3))]
    calls = []
    real = F.linear

    def recording(x, weight, bias=None):
        calls.append((x.numel() // x.shape[-1], weight.shape[0], weight.shape[1]))
        return real(x, weight, bias)

    monkeypatch.setattr(F, "linear", recording)
    with torch.no_grad():
        out = model(*args)
    monkeypatch.setattr(F, "linear", real)
    return (out if isinstance(out, tuple) else (out,)), calls


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_per_sample_products_run_at_a_fixed_row_count(name, monkeypatch):
    """Every product at batch 3 and at batch 5 in the same order: the same
    (N, K); M either the same in both, and then ``SAMPLE_ROWS`` (a
    per-sample product), ``FEW_TOKEN_ROWS`` (LTX-2's audio) or ``HEAD_ROWS``
    (an fp32 output head), or batch x the same token count, at least
    ``MIN_TOKENS``; and at least one per-sample product a forward."""
    _, calls3 = _forward(name, 3, monkeypatch)
    _, calls5 = _forward(name, 5, monkeypatch)
    assert len(calls3) == len(calls5)
    fixed = 0
    for (m3, n3, k3), (m5, n5, k5) in zip(calls3, calls5):
        assert (n3, k3) == (n5, k5)
        if m3 == m5:
            assert m3 in (SAMPLE_ROWS, FEW_TOKEN_ROWS, HEAD_ROWS), (name, m3, n3, k3)
            fixed += m3 == SAMPLE_ROWS
        else:
            assert m3 % 3 == 0 and m5 % 5 == 0 and m3 // 3 == m5 // 5 >= MIN_TOKENS, (name, m3, m5, n3, k3)
    assert fixed > 0


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_rows_give_the_same_bits_alone_as_in_a_larger_batch(name, monkeypatch):
    """Rows 0-2 of the batch of 5 are the batch of 3 bit for bit: the
    output of each stream."""
    out3, _ = _forward(name, 3, monkeypatch)
    out5, _ = _forward(name, 5, monkeypatch)
    for a, b in zip(out3, out5):
        assert torch.equal(b[:3], a), (name, float((b[:3] - a).abs().max()))


def test_fixed_rows_linear_pads_and_chunks():
    """``fixed_rows_linear``: within 1e-6 of ``F.linear`` at 0, 1, 32, 33 and
    70 rows and over leading dims; every product it runs has exactly
    ``rows`` rows (``SAMPLE_ROWS`` by default); a row's bits are the same
    whatever rows stand beside it; ``Linear(rows=...)`` runs it, in fp32
    unless told otherwise."""
    g = torch.Generator().manual_seed(0)
    w, b = torch.randn(24, 16, generator=g), torch.randn(24, generator=g)
    for n in (0, 1, 32, 33, 70):
        x = torch.randn(n, 16, generator=g)
        torch.testing.assert_close(fixed_rows_linear(x, w, b), F.linear(x, w, b), atol=1e-6, rtol=0)
    x = torch.randn(2, 5, 16, generator=g)
    assert fixed_rows_linear(x, w).shape == (2, 5, 24)
    seen = []
    real = F.linear
    try:
        F.linear = lambda x, *a: seen.append(x.shape[0]) or real(x, *a)
        fixed_rows_linear(torch.randn(70, 16, generator=g), w, b)
        fixed_rows_linear(torch.randn(3, 16, generator=g), w, b, rows=5)
    finally:
        F.linear = real
    assert seen == [SAMPLE_ROWS] * -(-70 // SAMPLE_ROWS) + [5]
    x = torch.randn(40, 16, generator=g)
    assert torch.equal(fixed_rows_linear(x, w, b)[:3], fixed_rows_linear(x[:3], w, b))
    lin = layers.Linear(16, 24, rows=SAMPLE_ROWS)
    assert lin.compute_dtype == torch.float32
    assert torch.equal(lin(x), fixed_rows_linear(x, lin.weight, lin.bias))


@pytest.mark.parametrize("masked", [False, True])
def test_sde_step_log_prob_rows_are_reduced_alone(masked):
    """The replayed transition's log-prob of rows 0-2 is the same bits in a
    batch of 3 as in a batch of 5 (each row reduced on its own), with and
    without a token mask; unmasked, each row alone gives its bits too."""
    from flow_factory_tpu_torch.scheduler.flow_match_euler import sde_step

    g = torch.Generator().manual_seed(1)
    v, x, nxt = (torch.randn(5, 48, 16, generator=g) for _ in range(3))
    mask = (torch.arange(48) >= 16).float()[None, :, None].expand(5, 48, 1) if masked else None
    kw = dict(dynamics_type="Flow-SDE", noise_level=0.7, compute_log_prob=True, storage_dtype=torch.float32)
    full = sde_step(v, x, 0.8, 0.7, next_latents=nxt, token_mask=mask, **kw).log_prob
    part = sde_step(v[:3], x[:3], 0.8, 0.7, next_latents=nxt[:3], token_mask=None if mask is None else mask[:3],
                    **kw).log_prob
    assert full.shape == (5,) and torch.equal(full[:3], part)
    if not masked:
        one = torch.stack([sde_step(v[i:i + 1], x[i:i + 1], 0.8, 0.7, next_latents=nxt[i:i + 1], **kw).log_prob[0]
                           for i in range(5)])
        assert torch.equal(one, full)
