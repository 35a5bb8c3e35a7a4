"""Opt-in launch environment profiles (the host allocator): the port's copy
of the JAX package's ``repro/launch/env.py``.

The launchers run with whatever environment they inherit; a profile is
applied ONLY when a launcher is invoked with ``--env-profile`` (never
implicitly: a profile re-execs the process, see below). The profiles:

``host``
    The host allocator for any launch:

    * ``LD_PRELOAD=<tcmalloc>``: glibc malloc serializes the large
      short-lived host allocations of batch building and checkpoint IO;
      tcmalloc's thread caches remove that contention. Detected from the
      usual distro paths (:func:`find_tcmalloc`); silently skipped when
      the library is not installed.
    * ``TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD=60000000000``: quiets
      tcmalloc's large-alloc warnings for multi-GB numpy batches.

    The JAX profile's ``TF_CPP_MIN_LOG_LEVEL`` and XLA flags have no
    meaning for PyTorch and are left out.

``cpu-mesh``
    The JAX profile splits the host CPU into ``--host-devices`` XLA
    devices for the sharded engines. The port has no sharded engine yet,
    so this profile, and ``--host-devices`` above 1, raise
    ``NotImplementedError`` naming ROADMAP queue 1 item 12.

Because ``LD_PRELOAD`` must be set before the process starts,
:func:`apply_env_profile` re-execs the current interpreter with the
profile's environment; the re-exec is guarded by
``REPRO_ENV_PROFILE_APPLIED=1`` so it happens exactly once.
:func:`profile_env` is the pure (testable) computation of the env delta.
"""
from __future__ import annotations

import os
import sys
from typing import Mapping

ENV_PROFILES = ("none", "host", "cpu-mesh")

_APPLIED_VAR = "REPRO_ENV_PROFILE_APPLIED"

# distro locations of tcmalloc, preferred first (full > minimal)
TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib64/libtcmalloc.so.4",
)


def _refuse_mesh(profile: str, host_devices: int) -> None:
    if profile == "cpu-mesh" or host_devices > 1:
        from repro_torch.api.spec import _not_ported
        raise _not_ported("--env-profile cpu-mesh / --host-devices > 1 (a "
                          "host split into devices for the sharded "
                          "engines)", "item 12")


def find_tcmalloc(paths: tuple[str, ...] = TCMALLOC_PATHS) -> str | None:
    """First installed tcmalloc shared object, or None."""
    for p in paths:
        if os.path.exists(p):
            return p
    return None


def profile_env(profile: str, *, host_devices: int = 1,
                base: Mapping[str, str] | None = None) -> dict[str, str]:
    """The env-var delta ``profile`` applies on top of ``base`` (defaults
    to the current process env). Pure: nothing is mutated or exec'd."""
    if profile not in ENV_PROFILES:
        raise ValueError(f"env profile must be one of {ENV_PROFILES}, "
                         f"got {profile!r}")
    if host_devices < 1:
        raise ValueError(f"host_devices must be >= 1, got {host_devices}")
    _refuse_mesh(profile, host_devices)
    base = dict(os.environ if base is None else base)
    if profile == "none":
        return {}
    env: dict[str, str] = {}
    lib = find_tcmalloc()
    if lib is not None:
        preload = base.get("LD_PRELOAD", "")
        if lib not in preload.split(":"):
            env["LD_PRELOAD"] = ":".join(x for x in (preload, lib) if x)
        env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = "60000000000"
    return env


def add_env_profile_args(ap) -> None:
    """Attach the shared ``--env-profile`` / ``--host-devices`` flags to an
    argparse parser, as every JAX launcher has them."""
    ap.add_argument("--env-profile", default="none", choices=ENV_PROFILES,
                    help="re-exec under a tuned launch environment (the "
                         "host allocator); 'cpu-mesh' is not ported (item "
                         "12)")
    ap.add_argument("--host-devices", type=int, default=1,
                    help="host device count of the 'cpu-mesh' profile "
                         "(anything but 1 raises: item 12)")


def apply_env_profile(profile: str | None, *,
                      host_devices: int = 1) -> bool:
    """Re-exec the current process under ``profile``'s environment.

    No-op (returns False) when the profile is ``None``/"none" or the
    process was already re-exec'd (``REPRO_ENV_PROFILE_APPLIED=1``; it
    then prints one ``[env] profile ... applied`` line). On
    the first call it does NOT return: the interpreter is replaced via
    ``os.execvpe`` with the same argv and the augmented env. Call this at
    the very top of a launcher ``main``, before any CUDA work.
    """
    if profile is None or profile == "none":
        _refuse_mesh("none", host_devices)
        return False
    if os.environ.get(_APPLIED_VAR) == "1":
        _refuse_mesh(profile, host_devices)
        print(f"[env] profile {profile} applied: LD_PRELOAD="
              f"{os.environ.get('LD_PRELOAD', '')}", flush=True)
        return False
    env = dict(os.environ)
    env.update(profile_env(profile, host_devices=host_devices))
    env[_APPLIED_VAR] = "1"
    sys.stdout.flush()
    os.execvpe(sys.executable, [sys.executable] + sys.argv, env)
    raise AssertionError("unreachable: execvpe does not return")
