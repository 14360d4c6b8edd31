"""PyTorch port, the TMA geometry of the head-dim-64 flash backward (K2a/K2b),
on the CPU: the 4-D tensor maps that ``csrc/flash_bwd.cu`` builds on the host
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
