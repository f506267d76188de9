"""The control: the reference one precision step lower (TF32 products, a
float8 atlas), put in the program's place, fails the cell's limits. On the
card at full frame size with a cut deck (the benchmark's own runs never
run it); the same readings at the cells' own sizes come from
``portbench/tools/readings.py``."""

import pytest

from portbench.lib import check, pages, spec
from portbench.lib.traffic import FilmedStream


@pytest.mark.card
@pytest.mark.parametrize("cell_name, slides, screen_above, frames", [
    ("orb64-filmed-x4", 16, 96, 24), ("orb500-filmed-x4", 4, 8, 24),
    ("orb64-screencap-x4", 16, 96, 96),     # 96 of 384 frames: about 11 reach the matcher
])
def test_the_control_is_not_correct(card, cell_name, slides, screen_above, frames):
    cell = spec.cell(cell_name)
    conf = cell["config"]
    conf["deck"]["pages"] = slides
    conf["match"]["screen_above_slides"] = screen_above
    deck = pages.make_deck(conf["deck"], 2**31 + 99, card)
    reference = spec.reference(conf)
    ref, ctl = reference(conf, deck), reference(conf, deck, control="fp8")
    stream = FilmedStream(cell["traffic"], cell["dwell"], conf["deck"], 2**31 + 99, 0)
    pairs = []
    for k in check.sample(2**31 + 99, 0, 128, 128 + 383, frames):
        r = check.answer(ref, stream, deck, k, 128)
        pairs.append((check.answer(ctl, stream, deck, k, 128), r, stream.page(k)))
    nums = check.numbers(pairs)
    assert any(nums[name] > limit for name, limit in cell["limits"].items()), nums
