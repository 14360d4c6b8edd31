"""PyTorch port, the TMA geometry of the flash kernels (K2a/K2b at head dim 64
and 128, the forwards' boxes), on the CPU: the 4-D tensor maps that
``csrc/flash_bwd.cu`` and ``csrc/flash_fwd_wgmma.cuh`` build on the host
take their global dims, byte strides, box and element type from
:func:`tma_geometry`, so the geometry must describe each view exactly. It is
checked by rebuilding the view from it with ``torch.as_strided`` over the same
storage, for the layouts the kernels read in place."""
import pytest
import torch

from flow_factory_tpu_torch.ops import attention as A

BF16 = 9  # CU_TENSOR_MAP_DATA_TYPE_BFLOAT16


def _view(layout: str, B: int, H: int, S: int, D: int = 64) -> torch.Tensor:
    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen).to(torch.bfloat16)
    if layout == "contiguous":  # the joint attention's concatenated q/k/v
        return rand(B, H, S, D)
    if layout == "head-split":  # (B, S, H, D).transpose(1, 2): a projection split into heads
        return rand(B, S, H, D).transpose(1, 2)
    if layout == "fused-qkv":  # one head's slice of a (B, S, 3, H, D) fused projection
        return rand(B, S, 3, H, D)[:, :, 1].transpose(1, 2)
    raise ValueError(layout)


def _rebuilt(t: torch.Tensor, geometry) -> torch.Tensor:
    """The view that the geometry describes, over t's storage."""
    (d0, d1, d2, d3), strides = geometry[:4], geometry[4:7]
    es = t.element_size()
    assert all(s % es == 0 for s in strides)
    return torch.as_strided(t, (d3, d2, d1, d0), (strides[2] // es, strides[1] // es, strides[0] // es, 1),
                            t.storage_offset())


@pytest.mark.parametrize("layout", ["contiguous", "head-split", "fused-qkv"])
@pytest.mark.parametrize("B,H,S", [(2, 3, 77), (1, 24, 1357), (16, 2, 64)])
def test_tma_geometry_describes_the_view(layout, B, H, S):
    t = _view(layout, B, H, S)
    g = A.tma_geometry(t)
    assert len(g) == 12
    assert g[:4] == (64, S, H, B)  # innermost first
    assert g[7:] == (64, 64, 1, 1, BF16)  # a 64 x 64 box of 128-byte rows
    assert all(s % 16 == 0 for s in g[4:7])
    assert torch.equal(_rebuilt(t, g), t)


def test_tma_geometry_of_a_head_split_view_reads_heads_at_128_bytes():
    """The head axis of a (B, S, H, D) tensor is its innermost after D: the
    strides are out of order, and the tensor map keeps them so."""
    B, H, S = 2, 3, 77
    g = A.tma_geometry(_view("head-split", B, H, S))
    assert g[4:7] == (H * 64 * 2, 64 * 2, S * H * 64 * 2)


@pytest.mark.parametrize("pad", [4, 1])
def test_tma_geometry_refuses_strides_off_16_bytes(pad):
    """A row pitch of 64 + pad elements (136 or 130 bytes) cannot be a TMA
    stride: the wrapper raises rather than build a map the card refuses."""
    t = torch.zeros(2, 3, 77, 64 + pad, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 16"):
        A.tma_geometry(t)


def test_tma_geometry_refuses_what_the_maps_do_not_take():
    with pytest.raises(ValueError):  # fp32: the TMA path is bf16 only
        A.tma_geometry(torch.zeros(1, 2, 64, 64))
    with pytest.raises(ValueError):  # head dim not contiguous
        A.tma_geometry(torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16).transpose(2, 3))
    with pytest.raises(ValueError):  # not (B, H, S, D)
        A.tma_geometry(torch.zeros(2, 64, 64, dtype=torch.bfloat16))


@pytest.mark.parametrize("layout", ["contiguous", "head-split", "fused-qkv"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,H,S", [(2, 3, 77), (16, 12, 512)])
def test_tma_geometry_with_the_forward_box_tiles_the_head_dim(layout, D, B, H, S):
    """The forward kernels' maps (K1, K3) take (64, 128) boxes: one 128-byte
    swizzle line of 64 columns by 128 rows, so a 128-wide head arrives as two
    boxes at columns 0 and 64. The geometry still describes the whole view,
    and the boxes' columns cover the head dim exactly."""
    t = _view(layout, B, H, S, D)
    g = A.tma_geometry(t, (64, 128))
    assert g[:4] == (D, S, H, B)
    assert g[7:] == (64, 128, 1, 1, BF16)
    assert torch.equal(_rebuilt(t, g), t)
    halves = [_rebuilt(t, g)[..., c:c + g[7]] for c in range(0, D, g[7])]
    assert len(halves) == D // 64 and torch.equal(torch.cat(halves, dim=-1), t)
    assert g[:7] == A.tma_geometry(t, (64, 64))[:7]  # the box changes nothing else


def test_tma_geometry_refuses_a_box_the_swizzle_does_not_take():
    t = _view("contiguous", 1, 2, 64, 128)
    for box in ((128, 64), (48, 64), (64, 512), (64, 0)):  # 256-byte lines, not dividing D, too many rows
        with pytest.raises(ValueError, match="box"):
            A.tma_geometry(t, box)
    with pytest.raises(ValueError, match="box"):
        A.tma_geometry(t)  # the default box is the whole head dim: 256 bytes at D = 128


def test_forward_tma_args_are_three_geometries_of_the_forward_box():
    q, k, v = (_view(layout, 2, 3, 77, 128) for layout in ("contiguous", "head-split", "fused-qkv"))
    args = list(A._fwd_tma_args(q, k, v))
    assert len(args) == 36
    # a 128-row q tile; key tiles of 64 rows at head dim 128 (128 at 64)
    assert args == [*A.tma_geometry(q, (64, 128)), *A.tma_geometry(k, (64, 64)), *A.tma_geometry(v, (64, 64))]
    q64, k64, v64 = (_view(layout, 2, 3, 77) for layout in ("contiguous", "head-split", "fused-qkv"))
    assert list(A._fwd_tma_args(q64, k64, v64)) == [x for t in (q64, k64, v64) for x in A.tma_geometry(t, (64, 128))]
    with pytest.raises(ValueError):  # fp32 has no TMA path (K1's fp32 variant takes none)
        A._fwd_tma_args(q.float(), k.float(), v.float())


#: (q, k, v, dO) layouts of the backward's callers: the joint attention's
#: concatenation, Wan's self-attention (q/k from RoPE, v a head split, dO
#: head-interleaved), Wan's cross-attention (k/v head splits of the context),
#: every operand a view, and views into a fused projection
_BWD_LAYOUTS = [("contiguous",) * 4, ("contiguous", "contiguous", "head-split", "head-split"),
                ("contiguous", "head-split", "head-split", "head-split"), ("head-split",) * 4,
                ("fused-qkv", "fused-qkv", "fused-qkv", "head-split")]


@pytest.mark.parametrize("layouts", _BWD_LAYOUTS)
@pytest.mark.parametrize("D", [64, 128])
def test_backward_tma_args_are_four_geometries_of_64_by_64_boxes(layouts, D):
    """K2a/K2b take a map of q, k, v and dO, in that order, each of 64 x 64
    boxes at both head dims (``csrc/flash_bwd.cu``): at 128 a 64-row tile is
    two boxes, at columns 0 and 64. Each geometry describes its view exactly
    (read back with ``torch.as_strided`` over the same storage), with Sq
    rows for q and dO and Sk for k and v, and its boxes tile the head dim."""
    Sq, Sk = 77, 130
    views = [_view(layout, 2, 3, S, D) for layout, S in zip(layouts, (Sq, Sk, Sk, Sq))]
    args = list(A._tma_args(*views))
    assert len(args) == 48
    for i, t in enumerate(views):
        g = tuple(args[12 * i:12 * i + 12])
        assert g[:4] == (D, t.shape[2], 3, 2)
        assert g[7:] == (64, 64, 1, 1, BF16)
        assert g == A.tma_geometry(t, (64, 64))
        rebuilt = _rebuilt(t, g)
        assert torch.equal(rebuilt, t)
        halves = [rebuilt[..., c:c + g[7]] for c in range(0, D, g[7])]
        assert len(halves) == D // 64 and torch.equal(torch.cat(halves, dim=-1), t)


def test_backward_tma_args_are_none_for_fp32():
    """The fp32 variant (head dim 64) reads its operands by plain loads: the
    wrapper passes a null geometry."""
    q = torch.zeros(1, 2, 64, 64)
    assert A._tma_args(q, q, q, q) is None
