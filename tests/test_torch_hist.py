"""The plain versions of the CUDA histogram kernels (ops/hist_cuda.py)
against the JAX package's Pallas wrappers run in interpret mode, at f32.

K1 leaf_histogram_masked and K2 leaf_histogram_masked_fused are the
identity-list calls of hist_blocklist / hist_blocklist_fused; K3 and K4
sweep the block list of a leaf that occupies one of two 8192-row blocks.
Counts are exact; grad/hess sums agree within 1e-5 of the leaf's sum of
|grad| / |hess| (f32 sums in another order); the fused rows pick the same
threshold per feature and the same best feature, with gains within 1e-5
relative.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import hist_pallas as jh
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu_torch.ops import hist_cuda as th
from lightgbm_tpu_torch.ops.split import PF_GAIN, PF_T, SplitParams

# one intra-op thread: with several, torch 2.13 on the CPU has (rarely,
# in a process that also runs XLA) returned one 2048-element chunk of
# its first elementwise result off in the fifth digit
torch.set_num_threads(1)

N, F, B = 16384, 10, 63
SUM_TOL = 1e-5
GAIN_TOL = 1e-5
PARAMS = (20, 1e-3, 0.1, 0.2, 0.0)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(3)
    bins = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    grad = rng.randn(N).astype(np.float32)
    hess = (rng.rand(N) + 0.1).astype(np.float32)
    # rows clustered by leaf, as the re-sort leaves them: leaf 2 lives in
    # block 1 only
    leaf = np.sort(rng.randint(0, 4, size=N)).astype(np.int32)
    bag = rng.rand(N) < 0.9
    eff = np.where(bag, leaf, -1).astype(np.int32)
    parent_eff = np.where(bag & (leaf >= 2), 0, -1).astype(np.int32)
    gh2 = np.stack([grad, hess])
    parent = np.asarray(jh.leaf_histogram_masked(
        jnp.asarray(bins), jnp.asarray(gh2), jnp.asarray(parent_eff),
        jnp.int32(0), max_bin=B, interpret=True))
    m = eff == 2
    small = (int(m.sum()), np.float32(grad[m].sum()),
             np.float32(hess[m].sum()))
    large_h = parent - np.asarray(jh.leaf_histogram_masked(
        jnp.asarray(bins), jnp.asarray(gh2), jnp.asarray(eff), jnp.int32(2),
        max_bin=B, interpret=True))
    large = (int(round(large_h[0, :, 2].sum())),
             np.float32(large_h[0, :, 0].sum()),
             np.float32(large_h[0, :, 1].sum()))
    fmask = np.ones(F, bool)
    fmask[6] = False
    t = dict(bins=torch.from_numpy(bins), gh2=torch.from_numpy(gh2),
             eff=torch.from_numpy(eff),
             two=torch.tensor(2, dtype=torch.int32),
             parent=torch.from_numpy(parent.copy()),
             fmask=torch.from_numpy(fmask),
             small=(torch.tensor(small[0], dtype=torch.int32),
                    torch.tensor(small[1]), torch.tensor(small[2])),
             large=(torch.tensor(large[0], dtype=torch.int32),
                    torch.tensor(large[1]), torch.tensor(large[2])))
    blist, n_active = th.block_plan(t["eff"], t["two"])
    abs_sums = (np.abs(grad[m]).sum(), np.abs(hess[m]).sum())
    return dict(bins=bins, gh2=gh2, eff=eff, parent=parent, fmask=fmask,
                small=small, large=large, t=t, blist=blist,
                n_active=n_active, abs_sums=abs_sums, leaf=leaf, bag=bag,
                variants={})


# the leaf shapes of the plain-vs-Pallas tests beyond the clustered leaf:
#   n_active_0  the clustered leaf's block list with n_active = 0, which
#               both packages clamp to 1 (its first block holds the leaf)
#   scattered   rows of every leaf in both blocks (no re-sort)
#   empty       no row of the target: block_plan gives n_active = 1 and
#               the histogram is zero
#   ties        feature 0 uses bins 10 and 50 only, so thresholds 11..50
#               give one split with equal gains (the larger threshold
#               wins), and feature 1 one bin only, so no split is valid
#               (threshold B - 1)
SHAPES = ["n_active_0", "scattered", "empty"]


def _variant(case, listed):
    """(torch args, torch plan, numpy inputs, JAX list arguments, fused
    tail, abs sums) of one leaf shape."""
    if listed in case["variants"]:
        return case["variants"][listed]
    bins, gh2, leaf, bag = case["bins"], case["gh2"], case["leaf"], case["bag"]
    target = 9 if listed == "empty" else 2
    if listed == "scattered":
        leaf = np.random.RandomState(5).permutation(leaf)
    if listed == "ties":
        bins = bins.copy()
        bins[0] = np.where(bins[0] < 31, 10, 50)
        bins[1] = 7
    eff = np.where(bag, leaf, -1).astype(np.int32)
    parent_eff = np.where(bag & (leaf >= 2), 0, -1).astype(np.int32)

    def jax_hist(e, tgt):
        return np.asarray(jh.leaf_histogram_masked(
            jnp.asarray(bins), jnp.asarray(gh2), jnp.asarray(e),
            jnp.int32(tgt), max_bin=B, interpret=True))

    parent = jax_hist(parent_eff, 0)
    large_h = parent - jax_hist(eff, target)
    m = eff == target
    small = (int(m.sum()), np.float32(gh2[0][m].sum()),
             np.float32(gh2[1][m].sum()))
    large = (int(round(large_h[0, :, 2].sum())),
             np.float32(large_h[0, :, 0].sum()),
             np.float32(large_h[0, :, 1].sum()))
    tgt = torch.tensor(target, dtype=torch.int32)
    blist, n_active = th.block_plan(torch.from_numpy(eff), tgt)
    if listed == "n_active_0":
        n_active = torch.tensor(0, dtype=torch.int32)
    args = (torch.from_numpy(bins), torch.from_numpy(gh2),
            torch.from_numpy(eff), tgt)
    tail = (torch.from_numpy(parent.copy()), torch.from_numpy(case["fmask"]),
            tuple(torch.tensor(v, dtype=torch.int32 if i == 0 else None)
                  for i, v in enumerate(small)),
            tuple(torch.tensor(v, dtype=torch.int32 if i == 0 else None)
                  for i, v in enumerate(large)))
    jcommon = (jnp.asarray(bins), jnp.asarray(gh2), jnp.asarray(eff),
               jnp.int32(target), jnp.asarray(blist.numpy()),
               jnp.int32(int(n_active)))
    jtail = (jnp.asarray(parent), jnp.asarray(case["fmask"]), small, large)
    out = dict(args=args, plan=(blist, n_active), tail=tail, jcommon=jcommon,
               jtail=jtail, abs_sums=(np.abs(gh2[0][m]).sum(),
                                      np.abs(gh2[1][m]).sum()))
    case["variants"][listed] = out
    return out


def _sums_close(want, got, abs_sums):
    np.testing.assert_array_equal(want[..., 2], got[..., 2])
    for c in (0, 1):
        err = np.abs(want[..., c] - got[..., c]).max()
        assert err <= SUM_TOL * abs_sums[c], (c, err)


def _pf_close(want, got):
    np.testing.assert_array_equal(want[:, PF_T], got[:, PF_T])
    assert np.argmax(want[:, PF_GAIN]) == np.argmax(got[:, PF_GAIN])
    fin = np.isfinite(want[:, PF_GAIN])
    np.testing.assert_array_equal(fin, np.isfinite(got[:, PF_GAIN]))
    rel = (np.abs(want[fin, PF_GAIN] - got[fin, PF_GAIN])
           / np.abs(want[fin, PF_GAIN]))
    assert rel.max(initial=0.0) <= GAIN_TOL, rel.max()


def test_block_plan(case):
    occ = (case["eff"] == 2).reshape(-1, th.ROW_BLOCK).any(axis=1)
    want = np.concatenate([np.flatnonzero(occ), np.flatnonzero(~occ)])
    np.testing.assert_array_equal(case["blist"].numpy(), want)
    assert int(case["n_active"]) == occ.sum() == 1


@pytest.mark.parametrize("listed", ["identity", "block_list"] + SHAPES)
def test_hist_blocklist_plain_vs_pallas(case, listed):
    t = case["t"]
    if listed in SHAPES:         # K3 on another leaf shape
        v = _variant(case, listed)
        want = jh.leaf_histogram_blocklist(*v["jcommon"], max_bin=B,
                                           interpret=True)
        got = th.hist_blocklist_plain(*v["args"], *v["plan"], max_bin=B)
        _sums_close(np.asarray(want), got.numpy(), v["abs_sums"])
        if listed == "empty":
            assert int(v["plan"][1]) == 1 and not got.any()
        assert torch.equal(got, th.hist_blocklist(*v["args"], *v["plan"],
                                                  max_bin=B))
        return
    if listed == "identity":     # K1
        want = jh.leaf_histogram_masked(
            jnp.asarray(case["bins"]), jnp.asarray(case["gh2"]),
            jnp.asarray(case["eff"]), jnp.int32(2), max_bin=B,
            interpret=True)
        plan = th.identity_plan(N, "cpu")
    else:                        # K3
        plan = (case["blist"], case["n_active"])
        want = jh.leaf_histogram_blocklist(
            jnp.asarray(case["bins"]), jnp.asarray(case["gh2"]),
            jnp.asarray(case["eff"]), jnp.int32(2),
            jnp.asarray(plan[0].numpy()), jnp.int32(int(plan[1])),
            max_bin=B, interpret=True)
    got = th.hist_blocklist_plain(t["bins"], t["gh2"], t["eff"], t["two"],
                                  *plan, max_bin=B)
    _sums_close(np.asarray(want), got.numpy(), case["abs_sums"])
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(got, th.hist_blocklist(
        t["bins"], t["gh2"], t["eff"], t["two"], *plan, max_bin=B))


@pytest.mark.parametrize("listed", ["identity", "block_list"] + SHAPES
                         + ["ties"])
def test_hist_blocklist_fused_plain_vs_pallas(case, listed):
    t = case["t"]
    jp = JParams(*PARAMS)
    if listed in SHAPES + ["ties"]:  # K4 on another leaf shape
        v = _variant(case, listed)
        want = jh.leaf_histogram_blocklist_fused(
            *v["jcommon"], *v["jtail"], max_bin=B, params=jp,
            interpret=True)
        got = th.hist_blocklist_fused_plain(
            *v["args"], *v["plan"], *v["tail"], max_bin=B,
            params=SplitParams(*PARAMS))
        _sums_close(np.asarray(want[0]), got[0].numpy(), v["abs_sums"])
        _pf_close(np.asarray(want[1]), got[1].numpy())
        _pf_close(np.asarray(want[2]), got[2].numpy())
        if listed == "ties":     # the larger threshold; B - 1 if none
            for pf in got[1:]:
                assert pf[0, PF_T] == 50 and pf[1, PF_T] == B - 1
                assert pf[6, PF_T] == B - 1
        if listed == "empty":
            assert (got[1][:, PF_T] == B - 1).all()
        return
    common = (jnp.asarray(case["bins"]), jnp.asarray(case["gh2"]),
              jnp.asarray(case["eff"]), jnp.int32(2))
    tail = (jnp.asarray(case["parent"]), jnp.asarray(case["fmask"]),
            case["small"], case["large"])
    if listed == "identity":     # K2
        want = jh.leaf_histogram_masked_fused(
            *common, *tail, max_bin=B, params=jp, interpret=True)
        plan = th.identity_plan(N, "cpu")
    else:                        # K4
        plan = (case["blist"], case["n_active"])
        want = jh.leaf_histogram_blocklist_fused(
            *common, jnp.asarray(plan[0].numpy()),
            jnp.int32(int(plan[1])), *tail, max_bin=B, params=jp,
            interpret=True)
    args = (t["bins"], t["gh2"], t["eff"], t["two"], *plan, t["parent"],
            t["fmask"], t["small"], t["large"])
    got = th.hist_blocklist_fused_plain(*args, max_bin=B,
                                        params=SplitParams(*PARAMS))
    _sums_close(np.asarray(want[0]), got[0].numpy(), case["abs_sums"])
    _pf_close(np.asarray(want[1]), got[1].numpy())
    _pf_close(np.asarray(want[2]), got[2].numpy())
    wrapped = th.hist_blocklist_fused(*args, max_bin=B,
                                      params=SplitParams(*PARAMS))
    assert all(torch.equal(a, b) for a, b in zip(got, wrapped))


def test_block_list_is_bitwise_the_full_sweep(case):
    t = case["t"]
    full = th.hist_blocklist_plain(t["bins"], t["gh2"], t["eff"], t["two"],
                                   *th.identity_plan(N, "cpu"), max_bin=B)
    listed = th.hist_blocklist_plain(t["bins"], t["gh2"], t["eff"],
                                     t["two"], case["blist"],
                                     case["n_active"], max_bin=B)
    assert torch.equal(full, listed)


def test_wrapper_off_the_cpu_launches_or_raises(case):
    """A tensor on another device never reaches the plain version: the
    wrapper checks it for the kernel and raises here, where there is no
    CUDA device."""
    t = case["t"]
    meta = [x.to("meta") for x in (t["bins"], t["gh2"], t["eff"], t["two"],
                                   case["blist"], case["n_active"])]
    with pytest.raises(ValueError, match="CUDA tensors"):
        th.hist_blocklist(*meta, max_bin=B)


def test_alignment_check_raises_on_an_offset_view():
    """The sweep stages bins in 16-byte loads, and leaf_eff and gh2 four
    rows a load: a row window of a fresh allocation passes; an offset
    view, rows a stride apart that is no multiple of 16, an offset
    leaf_eff or an offset gh2 raise (the wrappers run the check before
    every launch)."""
    wide = torch.zeros((F, N + 32), dtype=torch.uint8)
    eff = torch.zeros(N + 4, dtype=torch.int32)
    th.check_alignment(wide[:, :N], eff[:N])
    with pytest.raises(ValueError, match="16-byte"):
        th.check_alignment(wide[:, 3:3 + N], eff[:N])
    with pytest.raises(ValueError, match="16-byte"):
        th.check_alignment(torch.zeros((F, N + 8), dtype=torch.uint8)[:, :N],
                           eff[:N])
    with pytest.raises(ValueError, match="16-byte"):
        th.check_alignment(wide[:, :N], eff[1:N + 1])
    gh2 = torch.zeros((2, N + 4), dtype=torch.float32)
    th.check_alignment(wide[:, :N], eff[:N], gh2[:, :N])
    with pytest.raises(ValueError, match="gh2 must start"):
        th.check_alignment(wide[:, :N], eff[:N], gh2.view(-1)[1:2 * N + 1]
                           .view(2, N))


# -- the sweep's f32 summation order against chip_smoke.py's bound ----------
#
# chip_smoke.py holds the card's f32 sums to a per-bin bound derived from
# the sweep's summation order (csrc/hist.cu, "Every run gives the same
# bits").  Here that order is replayed in numpy float32 on the CPU, and the
# replay must stay within the bound of the plain f64-summed histogram,
# while the same histogram of bf16-rounded operands must break it.

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

ORDER_N, ORDER_F, ORDER_B = 2 * th.ROW_BLOCK, 4, 16
TILE = 1024


def _tree_sum(vals):
    """The pairwise tree over a group's rows in lane order: at level s the
    row of rank r (r a multiple of 2s) adds the partial of rank r + s."""
    v = [np.float32(x) for x in vals]
    s = 1
    while s < len(v):
        for r in range(0, len(v) - s, 2 * s):
            v[r] = np.float32(v[r] + v[r + s])
        s *= 2
    return v[0]


def emulate_sweep_f32(bins, gh2, eff, target, block_list, n_active, max_bin):
    """[F, max_bin, 3] float32 as the f32 sweep sums it: per tile, the
    in-leaf rows compacted in ascending order; sub-step (s, j) gives lane l
    compacted row 128 s + 4 l + j; per bin, the sub-step's rows summed by
    _tree_sum and added to the tile's bin in sub-step order; a block's 8
    tiles added in rank order; the blocks in list order."""
    f_, n = bins.shape
    nblk = n // th.ROW_BLOCK
    k = min(max(int(n_active), 1), nblk)
    acc = np.zeros((f_, th.MAX_BIN, 3), np.float32)
    for p in range(k):
        blk = min(max(int(block_list[p]), 0), nblk - 1)
        tiles = []
        for t in range(th.ROW_BLOCK // TILE):
            rows = blk * th.ROW_BLOCK + t * TILE + np.arange(TILE)
            rows = rows[eff[rows] == target]
            th_ = np.zeros((f_, th.MAX_BIN, 3), np.float32)
            for s0 in range(0, len(rows), 4 * 32):
                for j in range(4):
                    ks = s0 + 4 * np.arange(32) + j
                    r = rows[ks[ks < len(rows)]]
                    for f in range(f_):
                        b = bins[f, r]
                        for bb in np.unique(b):
                            sel = r[b == bb]
                            for c in (0, 1):
                                th_[f, bb, c] = np.float32(
                                    th_[f, bb, c] + _tree_sum(gh2[c, sel]))
                            th_[f, bb, 2] += len(sel)
            tiles.append(th_)
        blk_sum = tiles[0]
        for q in tiles[1:]:
            blk_sum = blk_sum + q
        acc = acc + blk_sum
    return acc[:, :max_bin]


@pytest.fixture(scope="module")
def order_case():
    rng = np.random.RandomState(11)
    bins = rng.randint(0, ORDER_B, size=(ORDER_F, ORDER_N)).astype(np.uint8)
    gh2 = np.stack([rng.randn(ORDER_N),
                    rng.uniform(0.05, 0.25, ORDER_N)]).astype(np.float32)
    eff = np.where(rng.rand(ORDER_N) < 0.3, 2, 0).astype(np.int32)
    return bins, gh2, eff


def _order_hists(order_case, kind):
    """(emulated, plain, plain of |gh2|, plain of bf16 gh2, count cap)."""
    bins, gh2, eff = order_case
    if kind == "skewed":
        bins = cs.skew_bins(torch.from_numpy(bins)).numpy()
    plan = th.identity_plan(ORDER_N, "cpu")
    emu = emulate_sweep_f32(bins, gh2, eff, 2, plan[0].numpy(), plan[1],
                            ORDER_B)
    t = [torch.from_numpy(x) for x in (bins, gh2, eff)]
    two = torch.tensor(2, dtype=torch.int32)

    def plain(g):
        return th.hist_blocklist_plain(t[0], g, t[2], two, *plan,
                                       max_bin=ORDER_B).double()
    return (torch.from_numpy(emu).double(), plain(t[1]), plain(t[1].abs()),
            plain(t[1].bfloat16().float()), int(plan[1]))


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_sweep_order_stays_within_the_chip_smoke_bound(order_case, kind):
    emu, plain, absum, _, n_active = _order_hists(order_case, kind)
    assert torch.equal(emu[..., 2], plain[..., 2])
    depth = cs.f32_depth(plain[..., 2], n_active)
    assert float(depth.max()) == cs.SWEEP_ROUNDINGS + n_active + 2
    for c in (0, 1):
        bound = depth * cs.F32_UNIT * absum[..., c]
        assert bool(((emu[..., c] - plain[..., c]).abs() <= bound).all()), c


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_bf16_control_breaks_the_chip_smoke_bound(order_case, kind):
    _, plain, absum, ctrl, n_active = _order_hists(order_case, kind)
    depth = cs.f32_depth(plain[..., 2], n_active)
    for c in (0, 1):
        bound = depth * cs.F32_UNIT * absum[..., c]
        live = bound > 0
        ratio = ((ctrl[..., c] - plain[..., c]).abs()[live] / bound[live])
        assert float(ratio.max()) > 1.0, c


def test_skew_bins_gives_the_skew_it_claims():
    rng = np.random.RandomState(13)
    bins = torch.from_numpy(rng.randint(0, 255, size=(7, th.ROW_BLOCK))
                            .astype(np.uint8))
    skew = cs.skew_bins(bins)
    assert torch.equal(skew[0::2], bins[0::2])
    odd = skew[1::2]
    share = float((odd == 0).double().mean())
    assert abs(share - cs.SKEW_SHARE) < 0.02, share
    kept = odd != 0
    assert torch.equal(odd[kept], bins[1::2][kept])
