"""The port's bfloat16 ops against the JAX package on the CPU, bit for bit.

- split2_bf16: hi is the float32 word's top 16 bits, lo = x - hi rounded to
  bfloat16; its VJP passes d(lo) alone.
- The packed grouping (group_with_idx on bfloat16 features, the
  packed_bf16_group switch on): one bfloat16 gather of [xyz_hi | xyz_lo |
  features], the xyz rebuilt and centred in float32; with the switch off,
  the float32 concatenation. Even payloads (6 + 6, 6 + 64) and an odd one
  (6 + 3). Its gradient against the JAX VJP through the VMEM gather kernel
  in interpret mode, whose backward sums bfloat16 cotangents in float32 and
  rounds once.
- gather_rows on bfloat16 rows and its gradient against the Pallas
  kernel's _bf16_gather (interpret mode) and its VJP, at a skewed index row
  where a bfloat16 running sum would round differently; the int32 lane
  pairs of the card's even-C route against _pack_bf16.
- The kernels' wrappers on a stand-in card: bfloat16 rows of even C reach
  gather.cu as int32 pairs, odd C as 2-byte words; bfloat16 cotangents reach
  scatter_add.cu's block route and card-wide sort with 2-byte elements, the
  block plans in the card's shared memory; bfloat16 rows on the MXU-gather
  route launch kernel e forward and f backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.ops import neighborhood as jnb
from pointnet2_scannet_tpu.ops.pallas import vmem_gather_kernel as jvk
from pointnet2_scannet_tpu_torch import ops
from pointnet2_scannet_tpu_torch.ops import neighborhood as pnb
from pointnet2_scannet_tpu_torch.ops import cuda as kernels
from pointnet2_scannet_tpu_torch.ops import tuning
from pointnet2_scannet_tpu_torch.ops.sampling import gather_rows
from pointnet2_scannet_tpu_torch.ops.cuda import gather_kernel as ga
from pointnet2_scannet_tpu_torch.ops.cuda import scatter_kernel as sc
from tests.test_torch_mxu_port import _interpret, _switch
from tests.test_torch_port_ops import fake_card  # noqa: F401  (a fixture)


def _bits(a) -> np.ndarray:
    """The 16-bit patterns of a bfloat16 torch tensor or JAX array."""
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _bf16(x: np.ndarray):
    """The same float32 numbers rounded to bfloat16 in both frameworks."""
    return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)


def _values(seed, shape):
    """float32 values over many binades, both signs, zeros and ties."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape) * 10.0 ** rng.uniform(-4, 3, shape)
    x.reshape(-1)[::17] = 0.0
    return x.astype(np.float32)


def test_split2_bf16_forward_and_vjp_equal_jax():
    x = _values(0, (2, 300, 3))
    x.reshape(-1)[1::17] = -0.0
    hi, lo = pnb.split2_bf16(torch.from_numpy(x))
    jhi, jlo = jnb.split2_bf16(jnp.asarray(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(hi), _bits(jhi))
    np.testing.assert_array_equal(_bits(lo), _bits(jlo))
    # hi truncates: its bits are x's top half; hi + lo keeps 16 mantissa bits
    np.testing.assert_array_equal(_bits(hi), (x.view(np.int32) >> 16).astype(np.int16))
    err = np.abs(hi.float().numpy() + lo.float().numpy() - x)
    assert np.all(err <= np.abs(x) * 2.0 ** -16)

    rng = np.random.default_rng(1)
    (ghi, jghi), (glo, jglo) = (_bf16(rng.normal(0, 1, x.shape).astype(np.float32)) for _ in range(2))
    xt = torch.from_numpy(x).requires_grad_()
    h, l = pnb.split2_bf16(xt)
    torch.autograd.backward([h, l], [ghi, glo])
    _, vjp = jax.vjp(jnb.split2_bf16, jnp.asarray(x))
    (want,) = vjp((jghi, jglo))
    assert xt.grad.dtype == torch.float32
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), glo.float().numpy())  # d(lo) alone


def _grouping_inputs(c, seed):
    """xyz, centroids, bfloat16 features and ball-query indices (B 2, N 256,
    M 64, K 16: repeated indices where a ball holds fewer than 16)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 1.5, (2, 256, 3)).astype(np.float32)
    new_xyz = xyz[:, :64].copy()
    feats = rng.normal(0, 2, (2, 256, c)).astype(np.float32)
    idx = np.asarray(jnb.ball_query(0.2, 16, jnp.asarray(xyz), jnp.asarray(new_xyz)))
    return xyz, new_xyz, feats, idx


@pytest.mark.parametrize("c", [6, 64, 3], ids=["payload12", "payload70", "payload9-odd"])
@pytest.mark.parametrize("packed", [True, False])
def test_packed_grouping_equals_jax(monkeypatch, c, packed):
    _switch(monkeypatch, packed_bf16_group=packed)
    xyz, new_xyz, feats, idx = _grouping_inputs(c, c)
    pf, jf = _bf16(feats)
    got = pnb.group_with_idx(torch.from_numpy(idx), torch.from_numpy(xyz), torch.from_numpy(new_xyz), pf)
    want = jnb.group_with_idx(jnp.asarray(idx), jnp.asarray(xyz), jnp.asarray(new_xyz), jf)
    assert got.shape == (2, 64, 16, 3 + c)
    assert got.dtype == (torch.bfloat16 if packed else torch.float32) and str(want.dtype) == str(got.dtype)[6:]
    if packed:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_grouping_gradient_equals_jax_vmem_vjp(monkeypatch):
    # the JAX grouping through the VMEM gather kernel (interpret mode): its
    # VJP sums the bfloat16 cotangents in float32 and rounds once, as the
    # port's scatter-add does; a payload under 32 channels keeps the JAX
    # backward off the split MXU scatter, whose sum order differs
    _switch(monkeypatch, vmem_gather=True)
    _interpret(monkeypatch)
    xyz, new_xyz, feats, idx = _grouping_inputs(6, 7)
    pf, jf = _bf16(feats)
    g = _values(8, (2, 64, 16, 9))
    pg, jg = _bf16(g)
    pf.requires_grad_()
    pxyz = torch.from_numpy(xyz).requires_grad_()
    out = pnb.group_with_idx(torch.from_numpy(idx), pxyz, torch.from_numpy(new_xyz), pf)
    out.backward(pg)
    want, vjp = jax.vjp(lambda x, f: jnb.group_with_idx(jnp.asarray(idx), x, jnp.asarray(new_xyz), f),
                        jnp.asarray(xyz), jf)
    np.testing.assert_array_equal(_bits(out), _bits(want))
    jgx, jgf = vjp(jg)
    np.testing.assert_array_equal(_bits(pf.grad), _bits(jgf))
    np.testing.assert_array_equal(pxyz.grad.numpy(), np.asarray(jgx))


def _skewed(seed, n, j):
    """Indices into n rows, a third of them naming row 5."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (2, j)).astype(np.int32)
    idx[:, rng.permutation(j)[: j // 3]] = 5
    return idx


@pytest.mark.parametrize("c", [2, 12, 70])
def test_gather_rows_bf16_and_its_gradient_equal_the_pallas_kernel(c):
    n, j = 256, 384
    src = _values(c, (2, n, c))
    idx = _skewed(c, n, j)
    g = np.random.default_rng(c + 1).uniform(0.5, 1.5, (2, j, c)).astype(np.float32)
    (psrc, jsrc), (pg, jg) = _bf16(src), _bf16(g)
    psrc.requires_grad_()
    got = gather_rows(psrc, torch.from_numpy(idx))
    got.backward(pg)
    want, vjp = jax.vjp(lambda s: jvk._bf16_gather(s, jnp.asarray(idx), True), jsrc)
    (jgrad,) = vjp(jg)
    assert got.dtype == psrc.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(psrc.grad), _bits(jgrad))
    # row 5's sum of ~128 cotangents: adding in bfloat16 would round apart
    run = torch.zeros((2, c), dtype=torch.bfloat16)
    for k in np.nonzero(idx[0] == 5)[0]:
        run[0] += pg[0, k]
    assert not torch.equal(run[0], psrc.grad[0, 5])


@pytest.mark.parametrize("c", [9, 70, 128])
def test_scatter_add_plain_bf16_equals_the_jax_vjp(c):
    n, j = 1024, 2048
    idx = _skewed(c, n, j)
    pg, jg = _bf16(_values(c, (2, j, c)))
    got = sc.scatter_add_plain(torch.from_numpy(idx), pg, n)
    want, _ = jvk._vjp_bwd(True, (jnp.asarray(idx), n), jg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # float32 cotangents keep their plain version: scatter_add_ in float32
    g32 = torch.from_numpy(_values(c, (2, j, c)))
    index = torch.from_numpy(idx).long().unsqueeze(-1).expand(2, j, c)
    assert torch.equal(sc.scatter_add_plain(torch.from_numpy(idx), g32, n),
                       torch.zeros((2, n, c)).scatter_add_(1, index, g32))


@pytest.mark.parametrize("c", [2, 12, 70])
def test_int32_lane_pairs_equal_pack_bf16(c):
    psrc, jsrc = _bf16(_values(c, (2, 128, c)))
    out = torch.empty((2, 5, c), dtype=torch.bfloat16)
    words, words_out = ga.bf16_words(psrc, out)
    assert words.dtype == words_out.dtype == torch.int32 and words.shape == (2, 128, c // 2)
    assert words.data_ptr() == psrc.data_ptr() and words_out.data_ptr() == out.data_ptr()  # views
    np.testing.assert_array_equal(words.numpy(), np.asarray(jvk._pack_bf16(jsrc)))
    np.testing.assert_array_equal(_bits(words.view(torch.bfloat16)), _bits(jvk._unpack_bf16(jvk._pack_bf16(jsrc), c)))


def test_gather_wrapper_sends_bf16_rows_as_int32_pairs_or_2_byte_words(fake_card):
    idx = torch.zeros((2, 300), dtype=torch.int32)
    for c, esize, words in ((12, 4, 6), (70, 4, 35), (16, 4, 8), (9, 2, 9)):
        ga.gather_cuda(torch.zeros((2, 64, c), dtype=torch.bfloat16), idx)
        name, args = fake_card.calls[-1]
        p = ga.plan(2, 64, 300, words, 132, esize)
        assert name == "p2_gather" and args[2:9] == (2, 64, 300, words, p.vec, p.per_thread, esize)
    # a row start off 4 bytes (a contiguous view one element in) moves 2-byte words
    src = torch.zeros(2 * 64 * 12 + 1, dtype=torch.bfloat16)[1:].view(2, 64, 12)
    ga.gather_cuda(src, idx)
    assert fake_card.calls[-1][1][5:9] == (12, 1, ga.plan(2, 64, 300, 12, 132, 2).per_thread, 2)
    assert ga.plan(2, 64, 300, 12, 132, 2).vec == 1 and ga.plan(2, 64, 300, 8, 132, 4).vec == 4
    assert ga.launches == 5 and ga.bf16_launches == 5
    ga.gather_cuda(torch.zeros((2, 64, 8)), idx)
    assert ga.launches == 6 and ga.bf16_launches == 5


def test_scatter_wrapper_sends_bf16_cotangents_with_2_byte_elements(fake_card):
    for j, n, c, route in ((8192, 1024, 70, "p2_scatter_add"), (24576, 1024, 128, "p2_scatter_add"),
                           (512, 64, 9, "p2_scatter_add"), (98304, 1024, 128, "p2_scatter_add_sort")):
        out = sc.scatter_add_cuda(torch.zeros((2, j), dtype=torch.int32),
                                  torch.zeros((2, j, c), dtype=torch.bfloat16), n)
        assert out.dtype == torch.bfloat16 and out.shape == (2, n, c)
        name, args = fake_card.calls[-1]
        p = sc.plan(2, n, j, c, 132, 2)
        assert name == route
        if route == "p2_scatter_add":
            assert args[6:12] == (p.chunks, p.vec, p.rows, p.walkers, p.page, 2)
            assert p.vec == sc.copy_vec(c, 2) == {70: 2, 128: 8, 9: 1}[c]
        else:
            assert args[6:10] == (p.tile, p.walkers, p.rows, 2)
    assert sc.launches == sc.bf16_launches == 4
    sc.scatter_add_cuda(torch.zeros((2, 64), dtype=torch.int32), torch.zeros((2, 64, 8)), 16)
    assert fake_card.calls[-1][1][11] == 4 and sc.launches == 5 and sc.bf16_launches == 4


def test_bf16_launches_count_where_the_kernel_launches(fake_card, monkeypatch):
    # launch() counts a bfloat16 launch, called directly too (int32 lane pairs
    # flagged bf16, 2-byte words by their dtype); a launch that fails counts none
    idx = torch.zeros((2, 300), dtype=torch.int32)
    src, out = torch.zeros((2, 64, 12), dtype=torch.bfloat16), torch.empty((2, 300, 12), dtype=torch.bfloat16)
    words, words_out = ga.bf16_words(src, out)
    ga.launch(words, idx, words_out, ga.plan(2, 64, 300, 6, 132), bf16=True)
    ga.launch(src[..., :9].contiguous(), idx, out[..., :9].contiguous(), ga.plan(2, 64, 300, 9, 132, 2))
    ga.launch(words, idx, words_out, ga.plan(2, 64, 300, 6, 132))  # int32 rows
    assert (ga.launches, ga.bf16_launches) == (3, 2)
    g = torch.zeros((2, 300, 9), dtype=torch.bfloat16)
    for p in sc.candidate_plans(2, 64, 300, 9, 132, 2):
        sc.launch(idx, g, 64, p)
    sc.launch(idx, g.float(), 64, sc.plan(2, 64, 300, 9, 132))
    assert (sc.launches, sc.bf16_launches) == (3, 2)
    monkeypatch.setattr(fake_card, "p2_gather", lambda *a: 700, raising=False)
    monkeypatch.setattr(fake_card, "p2_scatter_add", lambda *a: 700, raising=False)
    monkeypatch.setattr(fake_card, "p2_error_string", lambda e: b"an illegal address", raising=False)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        ga.gather_cuda(src, idx)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        sc.scatter_add_cuda(idx, g, 64)
    assert (ga.launches, ga.bf16_launches, sc.launches, sc.bf16_launches) == (3, 2, 3, 2)


def test_copy_vec_keeps_float32_choices_and_packs_bf16():
    assert [sc.copy_vec(c, 4) for c in (3, 4, 67, 128)] == [1, 4, 1, 4]
    assert [sc.copy_vec(c, 2) for c in (3, 4, 8, 70, 128, 9)] == [1, 2, 8, 2, 8, 1]


@pytest.mark.parametrize("sms", [114, 132])
def test_bf16_block_plans_fit_shared_memory(sms):
    # a bfloat16 entry takes half a float32 one's bytes in the page: at least
    # as many entries a page, and every plan inside the block's budget
    for b in (1, 2, 32):
        for n in (1, 16, 1024, 8192, sc.MAX_N):
            for j in (1, 192, 8192, 24576, sc.MAX_BLOCK_J):
                for c in (3, 9, 70, 128, 262, 512):
                    p = sc.block_plan(b, n, j, c, sms, 2)
                    if p is None:
                        continue
                    assert sc.block_bytes(p, j, 2) <= sc.BLOCK_BYTES and p.vec == sc.copy_vec(c, 2)
                    assert 1 <= p.page <= min(sc.MAX_PAGE, j)
                    f32 = sc.block_plan(b, n, j, c, sms, 4)
                    assert f32 is None or p.page >= f32.page


def test_bf16_rows_on_the_mxu_route_launch_e_and_f(monkeypatch, fake_card):
    # on a (stand-in) card, gather_points sends bfloat16 rows that pass the
    # MXU gate to e, and their gradient to f, under the P1 switches
    from pointnet2_scannet_tpu_torch.ops import mxu_gather, sampling

    _switch(monkeypatch, vmem_gather=False, mxu_gather=True)
    for mod in (sampling, mxu_gather):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
    tuning.reset_route_counts()
    src = torch.zeros((2, 256, 12), dtype=torch.bfloat16, requires_grad=True)
    out = ops.gather_points(src, torch.zeros((2, 256), dtype=torch.int32))
    assert tuning.route_counts[("gather", "mxu")] == 1 and out.dtype == torch.bfloat16
    out.backward(torch.zeros_like(out))
    assert [name for name, _ in fake_card.calls] == ["p2_gather_smem", "p2_scatter_smem"]
    assert kernels.bf16_launch_counts()["gather_smem"] == kernels.bf16_launch_counts()["scatter_smem"] == 1
