"""Allocator and XLA environment presets (a copy of
``repro.launch.env``; it imports the standard library only).

The reference tunes two things before its process starts: the malloc
implementation (``LD_PRELOAD`` of tcmalloc, which still applies to the
port's host loop) and XLA flags (``XLA_FLAGS``), which mean nothing to
torch: the port never starts XLA, so those presets are recorded but have
no effect. Both must be in the environment before the process starts,
so this module cannot retrofit them; it is a report-and-hint layer:

- ``preset(name)`` returns the recommended variables for a named
  preset, for launcher scripts to export before exec'ing Python.
- ``apply(name)`` sets any not-yet-set recommendations into
  ``os.environ``; ``LD_PRELOAD`` needs a process restart regardless.
- ``report(name)`` inspects the live process (environ plus
  ``/proc/self/maps`` for the actually-loaded allocator) and returns a
  JSON-able dict the run manifests embed (the server's manifest embeds
  ``report("throughput")``), so a run can be audited for its allocator
  and flag state after the fact.
"""
from __future__ import annotations

import os

# Candidate tcmalloc locations (Debian/Ubuntu multiarch, RHEL).
_TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib64/libtcmalloc.so.4",
)

PRESETS: dict[str, dict[str, str]] = {
    # Single-process scan throughput: one host device, step markers on
    # the outer while so profiles attribute time to scan iterations,
    # and tcmalloc when the host has it.
    "throughput": {
        "LD_PRELOAD": _TCMALLOC_PATHS[0],
        "XLA_FLAGS": ("--xla_force_host_platform_device_count=1 "
                      "--xla_step_marker_location=1"),
    },
    # Host-parallel sweeps (launch.mesh shards scenarios over host
    # devices): many virtual CPU devices, allocator as above.
    "sweep": {
        "LD_PRELOAD": _TCMALLOC_PATHS[0],
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
    },
}


def preset(name: str = "throughput") -> dict[str, str]:
    """Recommended environment for ``name`` (KeyError on unknown)."""
    if name not in PRESETS:
        raise KeyError(f"unknown env preset {name!r}; "
                       f"have {sorted(PRESETS)}")
    return dict(PRESETS[name])


def apply(name: str = "throughput") -> dict[str, str]:
    """Set not-yet-set recommendations into ``os.environ``; returns the
    variables actually written. Must run before jax import to have any
    effect (``LD_PRELOAD`` needs a process restart regardless)."""
    written = {}
    for key, val in preset(name).items():
        if not os.environ.get(key):
            os.environ[key] = val
            written[key] = val
    return written


def _loaded_allocator() -> str:
    """Which malloc is actually mapped: "tcmalloc" | "jemalloc" |
    "glibc" | "unknown" (non-Linux)."""
    try:
        with open("/proc/self/maps") as f:
            maps = f.read()
    except OSError:
        return "unknown"
    if "tcmalloc" in maps:
        return "tcmalloc"
    if "jemalloc" in maps:
        return "jemalloc"
    return "glibc"


def report(name: str = "throughput") -> dict:
    """JSON-able audit of the live process against ``name``: the
    recommendation, what is actually set/loaded, and whether they
    agree. Embedded under ``env_preset`` in run manifests."""
    want = preset(name)
    active = {key: os.environ.get(key) for key in
              ("LD_PRELOAD", "XLA_FLAGS", "XLA_PYTHON_CLIENT_PREALLOCATE",
               "JAX_PLATFORMS", "OMP_NUM_THREADS")}
    allocator = _loaded_allocator()
    want_flags = set(want.get("XLA_FLAGS", "").split())
    have_flags = set((active.get("XLA_FLAGS") or "").split())
    return {
        "preset": name,
        "recommended": want,
        "active": {k: v for k, v in active.items() if v},
        "allocator": allocator,
        "satisfied": (allocator == "tcmalloc"
                      and want_flags <= have_flags),
    }
