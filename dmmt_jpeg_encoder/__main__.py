"""`python -m dmmt_jpeg_encoder` entry point (reference: src/main.rs:5-12)."""

import sys

from .cli import main

sys.exit(main())
