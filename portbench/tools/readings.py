"""Readings from which a cell's limits are set, on the card.

    python3 portbench/tools/readings.py --workload <cell> --seeds 1 2 3 [--program]

For each seed it makes the cell's deck and, for each client, a sample of
``check_frames`` frames drawn as a run draws them (from the window's usual
span of frames), and answers them with the configuration's plain reference
(``spec.reference``) and with the control: the same reference one
precision step lower (TF32 for the float32 products the configuration
states with TF32 off), put in the program's place. With ``--program`` the port's engine in this process answers the
same frames too (``MatchingEngine.match_batch``, one frame a call, its
frame index as its seed, as the engine's batches do). It prints the
comparison's numbers of each against the reference. The benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import check, pages, spec  # noqa: E402
from portbench.lib.traffic import FilmedStream  # noqa: E402

FIRST, SPAN = 128, 1600    # frames a client decides in a window: from the warm batches on


def program_answers(cell: dict, deck, frames: list, device):
    """The port's answers for (frame index, image, changed) triples."""
    from slideo_tpu_torch.app import pipeline

    from portbench.client import build_config

    cfg = build_config(cell["config"])
    objs = [pipeline.PdfPage(Path("deck.pdf"), "deck", Path(f"p-{i + 1}.png"), i + 1)
            for i in range(deck.shape[0])]
    engine = pipeline.MatchingEngine(cfg, objs, device=device, page_grays=deck.cpu().numpy())
    out = []
    for k, img, changed in frames:
        if not changed:
            out.append(dict(changed=False))
            continue
        res = engine.match_batch(img[None], [k])
        out.append(dict(changed=True, slide=int(res.slide[0]), similarity=float(res.similarity[0]),
                        rating=float(res.rating[0])))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--traffic", default="{}", help="JSON of traffic parameters to override")
    ap.add_argument("--controls", type=int, default=3, help="seeds, from the first, that run the controls")
    ap.add_argument("--control", nargs="+", default=["fp8"], choices=["fp8", "int8", "tf32"])
    args = ap.parse_args()
    import torch

    dev = torch.device(args.device)
    cell = spec.cell(args.workload)
    cell["traffic"].update(json.loads(args.traffic))
    conf = cell["config"]
    Reference = spec.reference(conf)
    for seed in args.seeds:
        t0 = time.monotonic()
        deck = pages.make_deck(conf["deck"], seed, dev)
        ref = Reference(conf, deck)
        controls = {}
        if seed in args.seeds[:args.controls]:
            controls = {f"control_{c}": Reference(conf, deck, control=c) for c in args.control}
        pairs = {name: [] for name in controls}
        frames, truths, refs = [], [], []
        for c in range(cell["clients"]):
            stream = FilmedStream(cell["traffic"], cell["dwell"], conf["deck"], seed, c)
            for k in check.sample(seed, c, FIRST, FIRST + SPAN - 1, cell["check_frames"]):
                r = check.answer(ref, stream, deck, k, FIRST)
                for name, ctl in controls.items():
                    pairs[name].append((check.answer(ctl, stream, deck, k, FIRST), r, stream.page(k)))
                frames.append((k, stream.make([k], deck)[0], r["changed"]))
                truths.append(stream.page(k))
                refs.append(r)
        out = {"seed": seed, **{name: check.numbers(p) for name, p in pairs.items()}}
        if args.program:
            pairs_prog = list(zip(program_answers(cell, deck, frames, dev), refs, truths))
            out["program"] = check.numbers(pairs_prog)
        out["seconds"] = time.monotonic() - t0
        print(json.dumps(out), flush=True)
        del ref, controls, deck
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
