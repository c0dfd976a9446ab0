"""Golden streams (tests/golden.py): every preset's output for the golden
case set is byte-identical to the committed SHA-256 + length, and
roundtrips through stdlib zlib.

The CPU test holds the encoder to the goldens exactly.  The ``gpu`` test
runs the same cases on a card, where a stream may differ only if its
length stays within ``golden.LENGTH_TOLERANCE`` of the golden's.
"""

import pytest

import golden


@pytest.mark.parametrize("preset", golden.PRESETS)
def test_golden_streams_cpu(preset):
    rows = golden.compare_preset(preset)
    bad = [r for r in rows if r[1] != "identical"]
    assert not bad, f"{preset}: {len(bad)}/{len(rows)} cases differ: {bad}"


@pytest.mark.gpu
@pytest.mark.parametrize("preset", golden.PRESETS)
def test_golden_streams_gpu(preset, gpu_device):
    rows = golden.compare_preset(preset)
    bad = [r for r in rows if r[1] not in ("identical", "near")]
    assert not bad, f"{preset} on {gpu_device.device_kind}: {bad}"
