"""Logging-based run reporter: progress to stderr, results to stdout
(a copy of ``repro.obs.reporter``, on the ``repro_torch`` logger).

The reporter splits the CLI's two streams:

* **progress** (`.info` / `.debug`) goes through the stdlib ``logging``
  machinery to **stderr** and is silenced by ``--quiet``;
* **results** (`.result` / `.result_json`) are the program's actual
  output and go to **stdout**: human-formatted by default, or exactly
  one JSON document under ``--json`` (clean stdout for pipelines).

``Reporter.from_flags(args)`` is the one-liner the CLI uses after
``add_output_flags(parser)`` declared ``--quiet`` / ``--json``.
"""
from __future__ import annotations

import json
import logging
import sys
from typing import Optional

from repro_torch.obs import schema

LOGGER_NAME = "repro_torch"


def get_logger(name: str = LOGGER_NAME) -> logging.Logger:
    """The shared ``repro_torch`` logger, initialized to stderr on first use."""
    logger = logging.getLogger(name)
    root = logging.getLogger(LOGGER_NAME)
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(message)s"))
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logger


def add_output_flags(parser) -> None:
    """Declare the shared output-control flags on an argparse parser."""
    parser.add_argument("--quiet", action="store_true",
                        help="suppress progress output (stderr)")
    parser.add_argument("--json", action="store_true",
                        help="emit results as a single JSON document on "
                             "stdout (implies machine-clean output)")


class Reporter:
    """Two-channel run output: progress (stderr/logging) vs results
    (stdout). Under ``json_mode`` results accumulate and ``flush_json``
    prints them as one document."""

    def __init__(self, quiet: bool = False, json_mode: bool = False,
                 stream=None):
        self.quiet = bool(quiet)
        self.json_mode = bool(json_mode)
        self.stream = stream if stream is not None else sys.stdout
        self.logger = get_logger()
        logging.getLogger(LOGGER_NAME).setLevel(
            logging.WARNING if self.quiet else logging.INFO)
        self._doc: dict = {}

    @classmethod
    def from_flags(cls, args) -> "Reporter":
        return cls(quiet=getattr(args, "quiet", False),
                   json_mode=getattr(args, "json", False))

    # -- progress channel (stderr) -----------------------------------------
    def info(self, msg: str, *fmt) -> None:
        self.logger.info(msg, *fmt)

    def warn(self, msg: str, *fmt) -> None:
        self.logger.warning(msg, *fmt)

    # -- results channel (stdout) ------------------------------------------
    def result(self, text: str, key: Optional[str] = None, value=None) -> None:
        """A human-readable result block; under ``--json`` the text is
        dropped and (key, value) lands in the JSON document instead."""
        if self.json_mode:
            if key is not None:
                self._doc[key] = schema.jsonable(value)
        else:
            print(text, file=self.stream)

    def result_json(self, key: str, value) -> None:
        """A result that only exists in the JSON document (no text)."""
        if self.json_mode:
            self._doc[key] = schema.jsonable(value)

    def flush_json(self) -> None:
        """Print the accumulated JSON document (no-op outside --json)."""
        if self.json_mode:
            print(json.dumps(self._doc, indent=1, sort_keys=True),
                  file=self.stream)

    def log_fn(self):
        """A ``Callable[[str], None]`` view for APIs that take ``log=``
        (e.g. ``ml.train.train``)."""
        return self.logger.info
