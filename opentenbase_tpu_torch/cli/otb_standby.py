"""Hot-standby runner process (the reference's opentenbase_tpu/cli/
otb_standby.py): the standby side of streaming replication as its own
OS process, with a control port.

    python -m opentenbase_tpu_torch.cli.otb_standby --primary-host H \\
        --primary-port P --data-dir DIR [--serve-port N] \\
        [--control-port N] [--device cuda|cuda:N|cpu]

It applies the primary's WAL stream (otb_server --wal-port) and serves
read-only SQL on --serve-port (the JSON wire), on cuda:0 unless
--device says otherwise (no CUDA and no --device cpu: it refuses to
start). The control port takes line commands:

    status   -> JSON {role, applied, read_only}
    promote  -> pg_ctl promote: the standby goes read-write (its SQL port
                then takes writes); JSON {promoted: true}
    stop     -> clean shutdown
"""

from __future__ import annotations

import argparse
import json
import signal
import socket
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--primary-host", default="127.0.0.1")
    ap.add_argument("--primary-port", type=int, required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--datanodes", type=int, default=2)
    ap.add_argument("--shard-groups", type=int, default=256)
    ap.add_argument("--serve-port", type=int, default=0)
    ap.add_argument("--control-port", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the standby (default cuda:0)")
    args = ap.parse_args(argv)

    from opentenbase_tpu_torch.net.server import ClusterServer
    from opentenbase_tpu_torch.storage.replication import StandbyCluster

    try:
        sb = StandbyCluster(args.data_dir, args.datanodes, args.shard_groups,
                            device=args.device)
    except RuntimeError as e:
        ap.error(str(e))
    sb.start_replication(args.primary_host, args.primary_port)
    server = ClusterServer(sb.cluster, port=args.serve_port).start()

    ctl = socket.socket()
    ctl.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ctl.bind(("127.0.0.1", args.control_port))
    ctl.listen(4)
    print(f"standby ready sql=127.0.0.1:{server.port} "
          f"control=127.0.0.1:{ctl.getsockname()[1]} "
          f"(device {sb.cluster.device})", flush=True)

    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: done.set())
    signal.signal(signal.SIGINT, lambda *a: done.set())

    def handle(conn: socket.socket) -> None:
        try:
            f = conn.makefile("rw")
            for line in f:
                cmd = line.strip()
                if cmd == "status":
                    reply = {"role": "primary" if sb.promoted
                             else "standby", "applied": sb.applied,
                             "read_only": sb.cluster.read_only}
                elif cmd == "promote":
                    if not sb.promoted:
                        sb.promote()
                    reply = {"promoted": True}
                elif cmd == "stop":
                    reply = {"stopping": True}
                else:
                    reply = {"error": f"unknown command {cmd!r}"}
                f.write(json.dumps(reply) + "\n")
                f.flush()
                if cmd == "stop":
                    done.set()
                    return
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def accept_loop() -> None:
        while not done.is_set():
            try:
                conn, _ = ctl.accept()
            except OSError:
                return
            threading.Thread(target=handle, args=(conn,), daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()
    done.wait()
    server.stop()
    ctl.close()
    sb.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
