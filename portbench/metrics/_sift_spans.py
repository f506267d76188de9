"""What the readers of the SIFT matcher's stages share: milliseconds in some
of its stages over the frames it matched, one ``sift.features`` span a
frame. Each stage is read through ``Run.stage_seconds``, so only spans in
the window before the profile count, and a run whose program records none
of a reader's stages (an ORB cell, or a program without them) gives None."""

FRAMES = "sift.features"      # one span a matched frame


def ms_per_frame(run, names: tuple[str, ...]):
    """Milliseconds in the stages ``names`` over the frames matched, or
    None without spans of ``names[0]`` or of ``sift.features``."""
    got, frames = run.stage_seconds(names), run.stage_seconds((FRAMES,))
    if not got or not got[1] or not frames or not frames[1]:
        return None
    return got[0] * 1e3 / frames[1]
