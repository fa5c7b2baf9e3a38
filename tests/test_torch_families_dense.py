"""The tests of ``test_torch_families.py`` on the four dense archs
(tinyllama, smollm, yi, minitron) at their ``reduced()`` sizes."""

import pytest

from repro import configs as JC
from test_torch_families import (make_family,  # noqa: F401 (collected)
                                 test_attention_calls_count_a_forward,
                                 test_bf16_prefill_matches_decode,
                                 test_decode_fp32_matches_reference,
                                 test_forward_fp32_matches_reference,
                                 test_frontend_embeds,
                                 test_loss_and_grads_fp32_match_reference,
                                 test_params_from_reference_is_bit_exact,
                                 test_reduced_config_and_counts)

DENSE_ARCHS = [a for a in JC.ARCH_IDS if JC.get_config(a).family == "dense"]


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def fam(request):
    return make_family(request.param)
