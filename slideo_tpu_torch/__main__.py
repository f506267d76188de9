"""``python -m slideo_tpu_torch deck.pdf talk.mp4``: the port's slideo command line."""

from .app.cli import main

raise SystemExit(main())
