"""The yardstick's operation and byte counts."""

import pytest

from hipac_bench import counts


def test_resnet18_forward_is_1813_gmac_at_224():
    macs = counts.conv_macs()
    assert len(macs) == 20  # 17 3x3/7x7 convs and 3 downsamples
    assert macs["conv1"] == 112 * 112 * 64 * 3 * 49
    assert macs["layer2.0.conv2"] == 28 * 28 * 128 * 128 * 9
    assert macs["layer4.0.downsample.0"] == 7 * 7 * 512 * 256
    assert counts.forward_macs() == sum(macs.values()) + 512 * 2
    assert counts.forward_macs() / 1e9 == pytest.approx(1.8136, abs=5e-5)


def test_train_and_simclr_operations():
    fwd = counts.forward_macs()
    assert counts.train_flop() == 2 * (3 * fwd - counts.conv_macs()["conv1"])
    assert counts.projection_macs() == 512 * 512 + 512 * 128
    assert counts.nt_xent_flop(1024, 128) == 6 * 1024 ** 2 * 128


def test_kernel_bytes_and_bounds():
    assert counts.fused_normalize_bytes(512) / 1e6 == pytest.approx(231.2,
                                                                    abs=0.05)
    assert counts.augment_bytes(512) == 512 * 224 * 224 * 3 * 5
    assert counts.bound_s(counts.augment_bytes(512), 0) * 1e3 == \
        pytest.approx(0.1150, abs=1e-4)
    assert counts.bound_s(0, 989e12) == pytest.approx(1.0)
