"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. On a machine
with one, ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py`` builds the kernels and runs them at small
ragged shapes; ``chip_smoke.py`` covers the main path's shapes.
"""
import pytest
import torch

from repro_torch.core import packing
from repro_torch.core.schemes import CodeSpec
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _near_edge(z, spec, q):
    if spec.scheme == "sign":
        d = z.abs()
    elif spec.scheme == "2bit":
        d = torch.stack([(z + spec.w).abs(), z.abs(), (z - spec.w).abs()]).amin(0)
    else:
        v = (z + q if spec.scheme == "offset" else z) / spec.w
        d = (v - v.round()).abs() * spec.w
    return d <= 1e-5


@pytest.mark.parametrize("scheme,w", [("sign", 1.0), ("2bit", 0.75),
                                      ("uniform", 0.75), ("offset", 1.0)])
def test_gemm_kernels_match_plain(gen, scheme, w):
    spec = CodeSpec(scheme, w)
    x = torch.randn((300, 96), generator=gen, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    r = torch.randn((96, 100), generator=gen, device="cuda")
    q = torch.rand((100,), generator=gen, device="cuda") * w \
        if scheme == "offset" else None
    want = ref.coded_project_ref(x, r, spec, q)
    near = _near_edge(torch.matmul(x, r), spec, q)
    got = ops.coded_project(x, r, spec, q, impl="kernel")
    assert not bool(((got != want) & ~near).any())
    words = ops.encode_fused(x, r, spec, q, impl="kernel")
    got = packing.unpack_codes(words, spec.bits, 100)
    assert not bool(((got != want) & ~near).any())


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_pack_and_topk_kernels_bit_exact(gen, bits):
    codes = torch.randint(0, 1 << bits, (257, 100), generator=gen,
                          device="cuda", dtype=torch.int32)
    assert torch.equal(ops.pack_codes(codes, bits, impl="kernel"),
                       ref.pack_codes_ref(codes, bits))
    wq = ref.pack_codes_ref(codes[:9], bits)
    wdb = ref.pack_codes_ref(codes, bits)
    for top_k in (1, 10, 300):
        got = ops.packed_topk(wq, wdb, bits, 100, top_k, impl="kernel")
        want = ref.packed_topk_ref(wq, wdb, bits, 100, top_k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
