"""``predictionio_tpu_torch.device``: device choice and the scoped
matrix-product precision, including blocks that overlap across threads
(the TF32 flag they set is process-wide)."""

import threading

import pytest
import torch

from predictionio_tpu_torch.device import matmul_precision, resolve_device


def _tf32():
    return torch.backends.cuda.matmul.allow_tf32


@pytest.fixture
def tf32_off():
    prev = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


def test_precision_block_sets_and_restores(tf32_off):
    with matmul_precision("high"):
        assert _tf32()
        with matmul_precision("highest"):
            assert not _tf32()
        assert _tf32()
    assert not _tf32()
    with pytest.raises(ValueError, match="matmul precision"):
        with matmul_precision("tf32"):
            pass


def test_overlapping_blocks_in_threads(tf32_off):
    """Thread A opens "high", thread B opens "highest", A closes first,
    then B: TF32 is off while B's block is open, and the setting from
    before either block comes back after both."""
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with matmul_precision("high"):
            seen["a_alone"] = _tf32()
            a_in.set()
            b_in.wait(5)
            seen["a_beside_b"] = _tf32()
        a_out.set()

    def b():
        a_in.wait(5)
        with matmul_precision("highest"):
            b_in.set()
            a_out.wait(5)
            seen["b_after_a"] = _tf32()

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert seen == {"a_alone": True, "a_beside_b": False, "b_after_a": False}
    assert not _tf32()
