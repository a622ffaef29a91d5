"""The benchmark's frozen yardstick (``harness/yardstick.py``) equals the
program's originals (``textreid_torch/utils/profiling.py``) at the
cells' shapes: a change to either shows here."""

import pytest

from benchmark.harness import yardstick
from textreid_torch.utils import profiling

# batch, tokens, hidden of the cells' K1 launches; the ViT's attention
K1_SHAPES = [(128, 105, 512, 128 * 24), (128, 105, 512, 128 * 105),
             (1, 105, 512, 5)]
ATTENTION_SHAPES = [(128, 193, 768, 12)]


def test_peaks_equal_the_programs():
    assert yardstick.DEVICE_PEAKS == profiling.DEVICE_PEAKS


def test_family_table_equals_the_programs():
    assert tuple(yardstick.STEP_FAMILIES) == tuple(profiling.STEP_FAMILIES)
    for name in ("bigru_resident_bwd_kernel", "bigru_resident_kernel",
                 "attention_fwd_mma", "attention_bwd_mma",
                 "batch_norm_collect_statistics_channels_last_kernel",
                 "Memcpy HtoD (Pageable -> Device)", "nvjet_tst_192x192"):
        assert (yardstick.kernel_family(name)
                == profiling.kernel_family(name, profiling.STEP_FAMILIES))


@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("train", [False, True])
def test_k1_forward_work_equals_the_programs(shape, train):
    b, t, h, _ = shape
    assert (yardstick.k1_forward_work(b, t, h, train)
            == profiling.k1_forward_work(b, t, h, train))


@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("dw", [False, True])
def test_k1_backward_work_equals_the_programs(shape, dw):
    assert (yardstick.k1_backward_work(*shape, dw=dw)
            == profiling.k1_backward_work(*shape, dw=dw))


@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
def test_attention_work_equals_the_programs(shape, backward):
    assert (yardstick.attention_work(*shape, backward)
            == profiling.attention_work(*shape, backward))


def test_bound_equals_the_programs():
    peaks = yardstick.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]
    work = yardstick.k1_backward_work(128, 105, 512, 3000, dw=False)
    assert yardstick.bound_ms(*work, peaks) == profiling.bound_ms(*work,
                                                                  peaks)


@pytest.mark.parametrize("train", [False, True])
def test_k1_forward_work_over_valid_steps(train):
    b, t, h = 128, 105, 512
    whole = yardstick.k1_forward_work(b, t, h, train)
    assert yardstick.k1_forward_work(b, t, h, train, steps=b * t) == whole
    valid = yardstick.k1_forward_work(b, t, h, train, steps=3000)
    assert valid[0] == whole[0]
    assert valid[1]["bfloat16"] * b * t == whole[1]["bfloat16"] * 3000
