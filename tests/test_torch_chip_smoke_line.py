"""``chip_smoke.py``'s ``kernels`` line keeps its contract's keys: an entry's
extra fields cannot replace one of them (the sequence GRU's own route,
``cluster`` or ``grid``, once replaced the line's build route ``cuda``)."""

import pytest

import chip_smoke


def _row():
    return {"max_abs_err": 1e-7, "ms": 0.5, "plain_ms": 2.0, "bound_ms": 0.1, "bound_by": "bytes", "library_ms": None,
            "device_ms": 0.4}


def test_kernel_entries_keep_the_contract_keys():
    entry = chip_smoke._kernel_entry("gru_sequence", "src.cu", "ops.py:1", {"a": 2, "b": 3}, _row(), "T=1",
                                     seq_route="cluster")
    assert set(chip_smoke.KERNEL_LINE_KEYS) <= set(entry)
    assert entry["route"] == "cuda" and entry["seq_route"] == "cluster" and entry["launches"] == 5
    for key in ("route", "bound_by", "ms"):
        with pytest.raises(ValueError, match=key):
            chip_smoke._kernel_entry("gru_sequence", "src.cu", "ops.py:1", {"a": 2}, _row(), "T=1", **{key: "x"})
