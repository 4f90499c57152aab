"""The last JAX defs given a port counterpart, on the CPU against the JAX
package, exactly: ops/seeding.lookup_seeds (the full-depth searchsorted
lookup) and dryrun.entry() (the single-card align step of
__graft_entry__.entry())."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from aligngraph_tpu.ops import seeding as jsd
from aligngraph_tpu_torch import dryrun
from aligngraph_tpu_torch.ops import seeding as tsd
from tests.test_torch_seeding import INDEX_CASES, genome_with_ns, reads_from


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_lookup_seeds_equals_jax_and_bucketed(case):
    """As tests/test_read_aligner.py:237-290 (the bucketed and the
    direct-addressed index): lookup_seeds equals the JAX package's in
    every slot, and the port's lookup_seeds_bucketed in its mask and in
    every posflip the mask keeps; a repetitive seed (more than max_hits
    copies) is dropped."""
    sl, n, n_rate = INDEX_CASES[case]
    genome = genome_with_ns(2, n, n_rate)
    qs = reads_from(genome, 7, n_rate=0.002)
    genome_rep = genome.copy()
    for k in range(12):
        genome_rep[1000 + 200 * k:1000 + 200 * k + 100] = qs[0]
    for g in (genome, genome_rep):
        jidx = jsd.build_index(g, sl)
        tidx = tsd.build_index(g, sl, device="cpu")
        pk, _, valid = jsd.pack_query_seeds(jnp.asarray(qs), sl, 8)
        pcan = jnp.minimum(pk, jsd.rc_packed(pk, sl))
        pcan_t = torch.from_numpy(np.array(pcan))
        valid_t = torch.from_numpy(np.array(valid))
        want_pf, want_ok = jsd.lookup_seeds(
            jidx.sorted_kmers, jidx.sorted_posflip, pcan, valid, 8)
        got_pf, got_ok = tsd.lookup_seeds(tidx.sorted_kmers,
                                          tidx.sorted_posflip, pcan_t,
                                          valid_t, 8)
        assert got_pf.dtype == torch.int32 and got_ok.dtype == torch.bool
        np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
        np.testing.assert_array_equal(got_pf.numpy(), np.asarray(want_pf))
        b_pf, b_ok = tsd.lookup_seeds_bucketed(
            tidx.sorted_kmers, tidx.sorted_posflip, tidx.bucket_lo, pcan_t,
            valid_t, 8, tidx.search_steps, tidx.suffix_bits)
        ok = got_ok.numpy()
        np.testing.assert_array_equal(b_ok.numpy(), ok)
        np.testing.assert_array_equal(b_pf.numpy()[ok], got_pf.numpy()[ok])
        assert ok.sum() > 100
    # the repeated read's first seed has 13 copies in genome_rep: dropped
    assert not got_ok.numpy()[0, 0].any()


def test_entry_equals_jax_entry():
    """dryrun.entry("cpu")'s step against __graft_entry__.entry()'s, jitted
    on the CPU: every output of the full [P, K] layout equal, field by
    field, in every slot.  The two steps give the same fields (fr, valid,
    score, src_start, src_end, src_gap, src_size, tgt_start, tgt_end,
    tgt_gap, segs): none is without a counterpart."""
    fn, args = dryrun.entry("cpu")
    got = fn(*args)
    jfn, jargs = __graft_entry__.entry()
    want = jax.jit(jfn)(*jargs)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    # every pair of the tiny problem is placed
    assert got["valid"][:, 0].all() and got["valid"].sum() >= 32
    assert args[2].shape == (64, 64) and args[0].device.type == "cpu"


def test_entry_without_gpu_raises(monkeypatch):
    """entry() places its arguments on the card by default: with no CUDA
    device it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        dryrun.entry()
