"""The plain references, one module a reference, found by name.

A configuration (``configs/<config>.json``) is judged by
``references/<name>.py``, where ``<name>`` is its ``"reference"`` key or,
without one, its ``"engine"`` (``spec.reference``). Each such module holds
one class, ``Reference(conf, deck, control=None)``:

- ``conf`` is the configuration file as a dict; ``deck`` the pages
  [S, H, W] uint8 on the device the comparison runs on, made by the
  benchmark from the seed; ``control`` names a control, the same
  arithmetic one precision step below what the configuration states (the
  module's docstring lists the steps it offers), or None;
- ``changed(img, prev) -> bool``: whether the dedup passes frame ``img``
  [H, W] uint8 on, given the sample before it (None for the first sample
  of a stream, which always passes);
- ``match_frame(img, k) -> {"slide", "similarity", "rating",
  "keypoints"}``: for frame ``k`` of a stream (its index seeds the draws, as
  the engine's frame seeds do), the slide decided (-1 for none), the
  winner's similarity and rating, and the frame's valid keypoint count.

A reference imports nothing of the port, of the JAX package or of JAX, and
takes nothing the program made: it builds its own index from ``deck``. A
configuration that a reference does not compute raises
``NotImplementedError`` when the class is made.
"""
