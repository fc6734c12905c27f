"""graftlint rule registry. Each rule is ``check(ctx, config) -> findings``."""

from . import adapter, determinism, donation, hostsync, recompile, threadrace

RULES = {
    "HOSTSYNC": hostsync.check,
    "RECOMPILE": recompile.check,
    "DONATION": donation.check,
    "DETERMINISM": determinism.check,
    "THREADRACE": threadrace.check,
    "ADAPTER": adapter.check,
}

__all__ = ["RULES"]
