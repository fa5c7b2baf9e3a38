"""The zamba2 hybrid's case of ``test_torch_bf16_witness.py``: its bf16
prefill/decode logit error at a quarter of full width and full depth is
no larger than the reference's on the same weights."""

from test_torch_bf16_witness import hold_witness


def test_bf16_prefill_decode_drift_is_the_references_zamba2():
    hold_witness("zamba2-1.2b")
