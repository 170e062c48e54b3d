"""Telnet-style runtime control server (common/utils/telnetsrv analog).

The reference embeds a telnet server for live get/set of config values,
channel-model parameters, and measurement dumps (telnetsrv.c, and
rfsimulator's `rfsimu_setchanmod_cmd`, simulator.c:365).  This is the
line-oriented TCP equivalent: registered variables (get/set) and
commands over a plain socket, newline-framed.

Protocol:  get <name> | set <name> <value> | exec <cmd> [args...] |
           list | quit

A copy of openairinterface5g_tpu/utils/telnet.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_utils.py holds the two
codes equal.
"""
from __future__ import annotations

import socket
import threading
from typing import Any, Callable


class TelnetServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.vars: dict[str, list] = {}          # name -> [value, type]
        self.cmds: dict[str, Callable[..., str]] = {}
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(4)
        self._stop = False
        self.thread = threading.Thread(target=self._serve, daemon=True)

    @property
    def addr(self):
        return self.sock.getsockname()

    def register_var(self, name: str, value: Any):
        self.vars[name] = [value, type(value)]

    def register_cmd(self, name: str, fn: Callable[..., str]):
        self.cmds[name] = fn

    def get(self, name: str) -> Any:
        return self.vars[name][0]

    def start(self):
        self.thread.start()
        return self

    def stop(self):
        self._stop = True
        try:
            # unblock accept()
            socket.create_connection(self.addr, timeout=1).close()
        except OSError:
            pass
        self.thread.join(timeout=5)
        self.sock.close()

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            if self._stop:
                conn.close()
                return
            threading.Thread(target=self._client, args=(conn,),
                             daemon=True).start()

    def _client(self, conn: socket.socket):
        buf = b""
        with conn:
            while True:
                try:
                    chunk = conn.recv(4096)
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    resp = self._dispatch(line.decode().strip())
                    if resp is None:
                        return
                    conn.sendall((resp + "\n").encode())

    def _dispatch(self, line: str):
        parts = line.split()
        if not parts:
            return ""
        op = parts[0]
        try:
            if op == "quit":
                return None
            if op == "list":
                return " ".join(sorted(self.vars) + [f"[{c}]" for c in sorted(self.cmds)])
            if op == "get":
                return repr(self.get(parts[1]))
            if op == "set":
                slot = self.vars[parts[1]]
                slot[0] = slot[1](" ".join(parts[2:]))
                return "OK"
            if op == "exec":
                return str(self.cmds[parts[1]](*parts[2:]))
            return f"ERR unknown op {op!r}"
        except Exception as e:  # noqa: BLE001 - runtime CLI surfaces errors
            return f"ERR {type(e).__name__}: {e}"
