"""chip_smoke.py phase 2's per-row argmax verdict (argmax_verdicts) on
hand-made logits, and the to_integral launcher's choice of body
(kernel.body). Both are host code: no card needed.

A row whose kernel argmax differs from the plain one gets no verdict only
where the plain logits of the two tokens lie within TIE_ULPS bf16 ulps at
the row's largest |plain logit|; tau comes from the plain logits alone, so a
larger kernel error never widens it."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro_torch.kernels.to_integral import kernel as to_integral_kernel  # noqa: E402


def _plain():
    """Three rows over 6 tokens: row 0 a clear winner (token 2), row 1 an
    exact tie of tokens 1 and 4, row 2 a winner (token 5) 0.25 above token
    0, with |logit| at most 2.81 (one bf16 ulp there: 2^-6)."""
    return torch.tensor([[0.5, -1.0, 2.5, 0.0, 1.0, -2.0],
                         [-0.5, 2.8125, 0.0, 1.0, 2.8125, -1.0],
                         [2.5, 0.0, -1.0, 1.0, 0.5, 2.75]])


@pytest.mark.parametrize("x,ulp", [(2.81, 2 ** -6), (1.0, 2 ** -7), (0.999, 2 ** -8),
                                   (-300.0, 2.0), (0.0, 0.0)])
def test_bf16_ulp(x, ulp):
    assert chip_smoke.bf16_ulp(x) == ulp
    if x:   # the next bf16 value above x's rounding lies one ulp (at it) away
        b = torch.tensor(abs(x)).to(torch.bfloat16)
        nxt = (b.view(torch.int16) + 1).view(torch.bfloat16)
        assert nxt.item() - b.item() == chip_smoke.bf16_ulp(b.item())


def test_equal_argmax_agrees():
    want = _plain()
    got = want + 0.01 * torch.sin(torch.arange(18.0)).view(3, 6)
    got[1, 4] -= 0.1                          # the tie resolved as plain does
    v = chip_smoke.argmax_verdicts(got, want)
    assert v["agree_rows"] == [0, 1, 2] and not v["no_verdict_rows"]
    assert not v["failed_rows"]
    chip_smoke.require_argmax("equal", v)
    assert v["rows"][0]["plain_gap"] == pytest.approx(1.5)   # to the runner-up
    assert v["rows"][1]["plain_gap"] == 0.0


def test_exact_tie_gets_no_verdict():
    want = _plain()
    got = want.clone()
    got[1, 4] += 0.02                         # the kernel takes the other tied token
    v = chip_smoke.argmax_verdicts(got, want)
    assert v["no_verdict_rows"] == [1] and v["agree_rows"] == [0, 2]
    row = v["rows"][1]
    assert (row["kernel"], row["plain"], row["plain_gap"]) == (4, 1, 0.0)
    assert row["tau"] == chip_smoke.TIE_ULPS * 2 ** -6
    chip_smoke.require_argmax("tie", v)


def test_flip_beyond_tau_fails():
    want = _plain()
    got = want.clone()
    got[2, 0] += 0.3                          # token 0 over token 5: plain gap 0.25
    v = chip_smoke.argmax_verdicts(got, want)
    assert v["failed_rows"] == [2]
    assert v["rows"][2]["plain_gap"] == pytest.approx(0.25)
    assert v["rows"][2]["plain_gap"] > v["rows"][2]["tau"]
    with pytest.raises(AssertionError, match=r"rows \[2\]"):
        chip_smoke.require_argmax("flip", v)


def test_tau_does_not_depend_on_the_kernel_error():
    """The same flip fails whether the kernel's logits are otherwise exact
    or off by far more than the gap; tau stays what the plain logits give."""
    want = _plain()
    taus = []
    for noise in (0.0, 0.5, 5.0):
        got = want + noise * torch.cos(torch.arange(18.0)).view(3, 6)
        got[2] = want[2]
        got[2, 0] += 0.3
        v = chip_smoke.argmax_verdicts(got, want)
        assert 2 in v["failed_rows"]
        taus.append([r["tau"] for r in v["rows"]])
    assert taus[0] == taus[1] == taus[2]


@pytest.mark.parametrize("peak", [1e-3, 0.7, 1.0, 2.81, 100.0, 3e4])
def test_tau_is_no_looser_than_the_prefill_check_was(peak):
    """tau <= LOGITS_REL_L2 * max|logit|, the prefill's former limit."""
    tau = chip_smoke.TIE_ULPS * chip_smoke.bf16_ulp(peak)
    assert 0 < tau <= chip_smoke.LOGITS_REL_L2 * peak


@pytest.mark.parametrize("n,offset,body", [(32, 0, "vector"), (32, 1, "ballot"),
                                           (32, 16, "vector"), (31, 0, "ballot"),
                                           (1, 0, "ballot")])
def test_to_integral_body_by_shape_and_alignment(n, offset, body):
    flat = torch.zeros(5 * n + 64, dtype=torch.uint8)
    base = (-flat.data_ptr()) % 16                          # first 16-byte-aligned byte
    m = flat[base + offset: base + offset + 5 * n].view(5, n)
    assert to_integral_kernel.body(m) == body
