"""chip_smoke.py's comparison helpers on CPU arrays, and its refusal to run
without a GPU."""

import numpy as np
import pytest

import chip_smoke as cs


def test_sorted_pairs_and_same_pairs():
    a = cs.sorted_pairs([3, 1, 1], [0, 9, 2])
    np.testing.assert_array_equal(a[0], [1, 1, 3])
    np.testing.assert_array_equal(a[1], [2, 9, 0])
    assert cs.same_pairs(a, cs.sorted_pairs([1, 3, 1], [9, 0, 2]))
    assert not cs.same_pairs(a, cs.sorted_pairs([1, 3], [9, 0]))
    assert not cs.same_pairs(a, cs.sorted_pairs([1, 3, 1], [9, 1, 2]))


def test_kernel_pairs_reads_count_and_refuses_overflow():
    rrow = np.array([5, 2, 7, 0], np.int32)
    rpos = np.array([1, 4, 0, 0], np.int32)
    rows, pos = cs.kernel_pairs(rrow, rpos, 3, cap=4)
    np.testing.assert_array_equal(rows, [2, 5, 7])
    np.testing.assert_array_equal(pos, [4, 1, 0])
    with pytest.raises(AssertionError, match="overflow"):
        cs.kernel_pairs(rrow, rpos, 5, cap=4)


def test_rect_pairs_keeps_the_prefix_rectangle():
    rows, pos = cs.rect_pairs([0, 5, 9, 2], [100, 3, 1, 50], 6, 60)
    np.testing.assert_array_equal(rows, [2, 5])
    np.testing.assert_array_equal(pos, [50, 3])


def test_compare_scans_on_cpu_arrays():
    """The comparison phase 1 makes on the card, made here with the kernel
    in the interpreter and the XLA scan on the CPU."""
    import jax.numpy as jnp

    from havac.ops.ssv_gpu import ssv_gpu_scan
    from havac.ops.ssv_xla import ssv_scan_xla

    rng = np.random.default_rng(0)
    args = (jnp.asarray(rng.integers(0, 4, 3000).astype(np.uint8)),
            jnp.asarray(rng.integers(-40, 100, (64, 4)).astype(np.int8)),
            jnp.asarray(rng.integers(0, 256, 3000).astype(np.int32)),
            jnp.asarray(rng.integers(0, 256, 65).astype(np.int32)))
    kout = ssv_gpu_scan(*args, cap=1 << 16, interpret=True)
    xout = ssv_scan_xla(*args)
    res = cs.compare_scans(kout, xout, 1 << 16)
    assert res["hits"] and res["state"] and res["carry"]
    assert res["n_kernel"] == res["n_xla"] > 0
    broken = (kout[0], kout[1], kout[2], kout[3].at[7].add(1), kout[4])
    assert not cs.compare_scans(broken, xout, 1 << 16)["state"]


def test_require_raises():
    cs.require(True, "fine")
    with pytest.raises(AssertionError, match="check failed: x"):
        cs.require(False, "x")


def test_refuses_to_run_without_a_gpu(capsys):
    from havac.utils.device import NoGpuError

    with pytest.raises(NoGpuError):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out
