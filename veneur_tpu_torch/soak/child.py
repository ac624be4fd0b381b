"""One soak fleet role as a real OS process.

``python -m veneur_tpu_torch.soak.child <role> <spec.json>`` boots the
role (local | proxy | global | standby) from the shared
:class:`~veneur_tpu_torch.soak.orchestrator.FleetSpec` on the spec's
torch device (``cuda`` by default), prints one READY JSON line on
stdout, then serves the orchestrator's line protocol: one
command per stdin line, exactly one JSON ack per command on stdout
(logs go to stderr so they can never corrupt the protocol). The orchestrator
SIGKILLs this process for a scheduled kill — there is no crash
command; ``quit`` is the graceful path used at run end.

Commands: ``flush`` (driven interval; global acks its emitted ledger
value and steady-state sample), ``ckpt`` (checkpoint commit, retried
through injected ENOSPC), ``processed`` / ``imported`` (settle
reads), ``mode <m>`` (sink outage mode, global only), ``counters``
(monotone generation counters, read before a kill), ``hastatus``
(the StandbyManager snapshot — lease/replication state, global and
standby roles), ``ring`` (the proxy's live destination list, read by
the orchestrator's re-route wait), ``quit``."""

from __future__ import annotations

import json
import logging
import os
import sys


def _serve(role: str, spec_path: str) -> int:
    logging.basicConfig(stream=sys.stderr, level=logging.WARNING)

    from veneur_tpu_torch.soak.monitor import read_rss_kb
    from veneur_tpu_torch.soak.orchestrator import (
        GLOBAL_PREFIX, LOCAL_PREFIX, ChaosPost, FleetSpec,
        build_global_server, build_local_server, build_proxy,
        checkpoint_with_retry, drain_channel, global_counters,
        global_sample_fields, local_counters)

    with open(spec_path) as f:
        spec = FleetSpec.from_json(json.load(f))

    def ack(obj: dict) -> None:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    server = sink = dd = proxy = None
    chaos = ChaosPost()
    offered = [0]
    if role == "local":
        server, sink = build_local_server(spec)
    elif role == "global":
        server, sink, dd, offered = build_global_server(spec, chaos)
    elif role == "standby":
        server, sink, dd, offered = build_global_server(
            spec, chaos, role="standby")
    elif role == "proxy":
        proxy = build_proxy(spec)
    else:
        ack({"ready": False, "error": f"unknown role {role!r}"})
        return 2
    ack({"ready": True, "role": role, "pid": os.getpid()})

    for line in sys.stdin:
        cmd = line.strip()
        if not cmd:
            continue
        try:
            if cmd == "quit":
                ack({"ok": True})
                break
            elif cmd == "flush" and server is not None:
                server.flush()
                if role in ("global", "standby"):
                    emitted = drain_channel(sink, GLOBAL_PREFIX)
                    sample = global_sample_fields(server, dd)
                    sample["rss_kb"] = read_rss_kb()
                    sample["degradations"] = list(sample["degradations"])
                    ack({"ok": True, "emitted": emitted, "sample": sample})
                else:
                    ack({"ok": True,
                         "emitted": drain_channel(sink, LOCAL_PREFIX)})
            elif cmd == "ckpt" and server is not None:
                attempts = checkpoint_with_retry(server)
                ack({"ok": True, "attempts": attempts})
            elif cmd == "processed" and server is not None:
                ack({"v": server.store.processed})
            elif cmd == "imported" and server is not None:
                ack({"v": server.store.imported})
            elif cmd.startswith("mode ") and role in ("global", "standby"):
                chaos.mode = cmd.split(None, 1)[1]
                ack({"ok": True, "mode": chaos.mode})
            elif cmd == "counters":
                if role in ("global", "standby"):
                    ack({"counters": global_counters(server, dd, offered)})
                elif role == "local":
                    ack({"counters": local_counters(server)})
                else:
                    ack({"counters": {}})
            elif cmd == "hastatus":
                sby = getattr(server, "standby_manager", None)
                ack({"ha": sby.snapshot() if sby is not None else {}})
            elif cmd == "ring" and proxy is not None:
                ack({"members": list(proxy.ring.members())})
            else:
                ack({"ok": False, "error": f"bad command {cmd!r}"})
        except Exception as e:  # the ack keeps the protocol in sync
            logging.getLogger("veneur.soak.child").exception(
                "command %r failed", cmd)
            ack({"ok": False, "error": f"{type(e).__name__}: {e}"})
    try:
        if server is not None:
            server.shutdown()
        if proxy is not None:
            proxy.shutdown()
    except Exception:
        pass
    return 0


def main(argv) -> int:
    if len(argv) != 3:
        print("usage: python -m veneur_tpu_torch.soak.child "
              "<local|proxy|global|standby> <spec.json>", file=sys.stderr)
        return 2
    return _serve(argv[1], argv[2])


if __name__ == "__main__":
    sys.exit(main(sys.argv))
