"""Dense decode attention's route to the flash-decoding kernel.

On the card ``decode_attention_dense`` reads one layer's dense cache
through ``stitched_decode_attention`` as an arena of B chunks of S tokens
under the identity page table. The kernel runs only on the card
(``chip_smoke.py`` holds it there); here the route's helper, called on CPU
tensors, goes through the kernel wrapper's plain version and is held to
the plain path that ``decode_attention_dense`` keeps for CPU tensors. Also:
the CPU path never takes the route, and neither a training step nor a CPU
decode builds or loads a kernel."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.launch import serve, train
from repro_torch.models import layers as L
from repro_torch.utils import tracing

S, KVH = 80, 2


def _case(b, group, d, lengths, dtype, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, 1, KVH * group, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, S, KVH, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, S, KVH, d)).astype(np.float32))
    if lengths == "one":
        lens = np.ones(b)
    elif lengths == "full":
        lens = np.full(b, S)
    else:  # a ragged mix holding 1 and S when there is room
        lens = rng.integers(1, S + 1, size=b)
        lens[:2] = [1, S][:b]
    return (q.to(dtype), k.to(dtype), v.to(dtype),
            torch.from_numpy(lens.astype(np.int32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("lengths", ["one", "full", "ragged"])
@pytest.mark.parametrize("window", [None, 32, S + 7], ids=["nowin", "win32", "winlong"])
@pytest.mark.parametrize("d", [64, 120, 128])
@pytest.mark.parametrize("group", [1, 3, 6, 12])
@pytest.mark.parametrize("b", [1, 7])
def test_route_matches_plain_dense_path(b, group, d, window, lengths, dtype):
    q, k, v, lens = _case(b, group, d, lengths, dtype, seed=b * 1000 + group * 10 + d)
    got = L._decode_attention_kernel(q, k, v, lens, window=window)
    want = L.decode_attention_dense(q, k, v, lens, window=window)
    assert got.shape == want.shape == q.shape and got.dtype == dtype
    if dtype == torch.float32:
        # the same f32 arithmetic in another summation order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        # the plain path rounds each probability to bf16 before P.V (2^-9
        # relative), the route keeps it in f32: the sums differ by at most
        # 2^-9 max|v|, allowed twice; and each output is rounded to bf16 once
        # on either side, so they may sit an ulp (2^-8 relative) apart
        atol = 2.0**-8 * float(v.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7, atol=atol)


@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chip_smoke_plain_path_is_the_cpu_path(window, dtype):
    """``chip_smoke.dense_plain``, which the card's route is held to and
    timed against, is the plain path ``decode_attention_dense`` keeps for
    CPU tensors, bit for bit."""
    import chip_smoke

    q, k, v, lens = _case(7, 6, 64, "ragged", dtype, seed=8)
    assert torch.equal(chip_smoke.dense_plain(q, k, v, lens, window=window),
                       L.decode_attention_dense(q, k, v, lens, window=window))


def test_route_masks_before_the_window():
    """Positions before ``len - window`` take no weight: changing them
    leaves the output bit for bit as it was."""
    q, k, v, lens = _case(3, 4, 64, "full", torch.float32, seed=5)
    lens = torch.tensor([S, 50, 9], dtype=torch.int32)
    out = L._decode_attention_kernel(q, k, v, lens, window=8)
    k2, v2 = k.clone(), v.clone()
    for row, n in enumerate(lens.tolist()):
        k2[row, :n - 8] = 1e3
        v2[row, :n - 8] = -1e3
    assert torch.equal(L._decode_attention_kernel(q, k2, v2, lens, window=8), out)


def test_route_refuses_a_window_below_one():
    q, k, v, lens = _case(1, 1, 64, "full", torch.float32, seed=6)
    with pytest.raises(ValueError):
        L._decode_attention_kernel(q, k, v, lens, window=0)


def test_route_counts_each_call():
    """``attn.decode_kernel`` counts the calls taken to the kernel; the CPU
    path of ``decode_attention_dense`` takes none."""
    q, k, v, lens = _case(2, 3, 64, "ragged", torch.float32, seed=7)
    tracing.reset()
    tracing.enable()
    try:
        L.decode_attention_dense(q, k, v, lens)
        assert "attn.decode_kernel" not in tracing.snapshot()["counters"]
        L._decode_attention_kernel(q, k, v, lens)
        L._decode_attention_kernel(q, k, v, lens, window=4)
        assert tracing.snapshot()["counters"]["attn.decode_kernel"] == 2
    finally:
        tracing.disable()
        tracing.reset()


def test_training_and_cpu_decode_build_no_kernel(monkeypatch, tmp_path):
    """A smoke training run and a CPU serving run with the kernel builder
    patched to raise: neither reaches it."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel library was built or loaded")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    result, _ = train.run(train.parse_args(
        ["--arch", "starcoder2-15b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "32",
         "--ckpt-dir", str(tmp_path), "--device", "cpu"]))
    assert result["steps"] == 2 and np.isfinite(result["last_loss"])
    out = serve.main(["--arch", "starcoder2-15b", "--smoke", "--requests", "3", "--max-new", "3",
                      "--max-batch", "2", "--device", "cpu"])
    assert out["finished"] == out["requests"] == 3
