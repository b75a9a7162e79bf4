"""Streaming match-serving daemon: session-per-connection, online dictionary.

The reference is a library embedded in one process; this example shows the
framework's serving shape on the device: ONE machine + ONE device scanner shared by
all connections, a StreamSession per connection (exact matches across chunk
edges, resumable), and online keyword registration absorbed into the live
device tables via DenseScanner.refresh() — no rebuild, no re-upload, no
recompile (see benchmarks/bench_refresh.py for the turnaround numbers).

Line protocol (UTF-8, one command per line):

    ADD <keyword>     register a keyword (visible from the next FEED on,
                      reference insert-during-scan semantics, README.md:352-356)
    FEED <text>       stream a chunk; replies "<n> <total>" (chunk/session hits)
    MATCHES <text>    stream a chunk; replies one "<start> <end> <keyword>"
                      line per hit (absolute stream positions), then "."
    TOTAL             replies the session's running total
    QUIT              closes the connection

Run a server:          python examples/serving_demo.py --serve [port]
Self-driving demo:     python examples/serving_demo.py
"""

from __future__ import annotations

import socket
import socketserver
import sys
import threading

import aho_corasick_1975_tpu as ac


class MatchServer(socketserver.ThreadingTCPServer):
    """Shared machine + scanner; per-connection sessions are made by the
    handler. One lock serializes device work (scans and snapshot refresh —
    refresh() donates buffers, so it must not race an in-flight scan).

    add_keyword deliberately runs OUTSIDE device_lock: keyword insertion
    and Machine.compile() are made atomic by the machine's own internal
    lock (the reference's machine mutex, c:295,344), so a handler thread
    inserting while another refreshes cannot observe a torn snapshot; the
    device_lock's only job is scanner buffer exclusion."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, keywords=(), scanner_kwargs=None):
        self.machine = ac.Machine()
        for kw in keywords:
            self.machine.insert_keyword(kw)
        self.scanner = self.machine.scanner(**(scanner_kwargs or {}))
        self.device_lock = threading.Lock()
        self._dirty = threading.Event()
        super().__init__(addr, MatchHandler)

    # -- online dictionary --------------------------------------------------

    def add_keyword(self, kw: str) -> None:
        self.machine.insert_keyword(kw)  # host-side Meyer insert, ~us
        self._dirty.set()

    def catch_up(self) -> None:
        """Absorb pending insertions into the device snapshot (cheap when
        nothing changed: one version compare)."""
        if self._dirty.is_set():
            with self.device_lock:
                if self._dirty.is_set():
                    self._dirty.clear()
                    self.scanner.refresh()


class MatchHandler(socketserver.StreamRequestHandler):
    def handle(self):
        server: MatchServer = self.server
        with server.device_lock:
            session = server.scanner.session()
        for raw in self.rfile:
            line = raw.decode("utf-8", errors="replace").rstrip("\r\n")
            cmd, _, arg = line.partition(" ")
            cmd = cmd.upper()
            if cmd == "QUIT":
                break
            try:
                self._dispatch(server, session, cmd, arg)
            except Exception as e:  # keep the connection alive
                self._reply(f"ERR {type(e).__name__}: {e}")

    def _dispatch(self, server, session, cmd: str, arg: str) -> None:
        if cmd == "ADD":
            server.add_keyword(arg)
            self._reply("OK")
        elif cmd == "FEED":
            server.catch_up()
            with server.device_lock:
                n = session.feed_count(arg)
            self._reply(f"{n} {session.total}")
        elif cmd == "MATCHES":
            server.catch_up()
            with server.device_lock:
                hits = session.feed_matches(arg)
            for ev, mt in hits:
                self._reply(f"{ev.start} {ev.end} {mt.text()}")
            self._reply(".")
        elif cmd == "TOTAL":
            self._reply(str(session.total))
        else:
            self._reply(f"ERR unknown command {cmd!r}")

    def _reply(self, s: str) -> None:
        self.wfile.write((s + "\n").encode("utf-8"))
        self.wfile.flush()


# -- self-driving demo -------------------------------------------------------

class Client:
    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.f = self.sock.makefile("rwb")

    def cmd(self, line: str) -> str:
        self.f.write((line + "\n").encode());  self.f.flush()
        return self.f.readline().decode().rstrip("\n")

    def cmd_multi(self, line: str) -> list:
        self.f.write((line + "\n").encode());  self.f.flush()
        out = []
        while True:
            r = self.f.readline().decode().rstrip("\n")
            if r == ".":
                return out
            out.append(r)

    def close(self):
        self.cmd("QUIT")
        self.sock.close()


def demo() -> None:
    server = MatchServer(("127.0.0.1", 0), keywords=["he", "she", "his", "hers"])
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    print(f"serving on 127.0.0.1:{port}")

    c = Client(port)
    text = "To ushers: he found his pencil, but she could not find hers."
    print("FEED #1 ->", c.cmd("FEED " + text[:30]))
    print("FEED #2 ->", c.cmd("FEED " + text[30:]))  # 'she' spans the edge
    print("TOTAL   ->", c.cmd("TOTAL"))

    # online registration: visible from the next chunk on
    print("ADD pencil ->", c.cmd("ADD pencil"))
    for hit in c.cmd_multi("MATCHES  he lost his pencil again"):
        print("  hit:", hit)

    # a second concurrent session has its own cursor but the same dictionary
    c2 = Client(port)
    print("client2 ->", c2.cmd("FEED a pencil for hers"))
    c2.close()
    c.close()
    server.shutdown()
    print("demo OK")


def main() -> None:
    if "--serve" in sys.argv:
        port = int(sys.argv[-1]) if sys.argv[-1].isdigit() else 9075
        server = MatchServer(("127.0.0.1", port),
                             keywords=["he", "she", "his", "hers"])
        print(f"serving on 127.0.0.1:{server.server_address[1]} "
              "(ADD/FEED/MATCHES/TOTAL/QUIT)")
        server.serve_forever()
    else:
        demo()


if __name__ == "__main__":
    main()
