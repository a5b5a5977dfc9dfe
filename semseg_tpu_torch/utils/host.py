"""The host's CPU identity (``semseg_tpu/utils/compile_cache.py::host_fingerprint``,
the port's own copy).

A library built with ``-march=native`` runs only on CPUs with the building host's
instruction set, and may crash with SIGILL on another. A checkout (and its
``build/`` directory) may move between hosts, so the port's native
preprocessing library (``semseg_tpu_torch.native``) lives under a directory
named by this fingerprint.
"""

from __future__ import annotations

import hashlib
import platform


def host_fingerprint() -> str:
    """A 10-hex-digit hash of the CPU's model and feature flags.

    The key holds the CPU *model* (vendor, family, model, stepping,
    microcode), not only the feature flags: a compiler derives model-based
    tuning from CPUID, so two hosts with equal ``flags`` lines can still
    build binaries that do not run on each other.
    """
    feats = ""
    ident = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key_, _, val = line.partition(":")
                key_ = key_.strip()
                # x86 lists capabilities under "flags", aarch64 under
                # "Features".
                if not feats and key_ in ("flags", "Features"):
                    feats = " ".join(sorted(val.split()))
                elif key_ in ("vendor_id", "cpu family", "model",
                              "model name", "stepping", "microcode",
                              "CPU implementer", "CPU part",
                              "CPU variant", "CPU revision"):
                    ident.append(f"{key_}={val.strip()}")
                elif key_ == "processor" and ident:
                    break  # one core is enough
    except OSError:
        pass
    if not feats and not ident:
        # Non-Linux / unreadable cpuinfo: the coarsest stable host identity.
        feats = platform.processor() or platform.platform()
    key = f"{platform.machine()}:{';'.join(ident)}:{feats}"
    return hashlib.sha1(key.encode()).hexdigest()[:10]
