"""Database farm daemon — the monetdbd/merovingian analog
(tools/merovingian/daemon/: create/start/stop/snapshot databases in a
dbfarm, status registry, multiplex-funnel).

Differences from the reference, by design: databases run as in-process
Server threads rather than forked mserver processes (one process per host
owns the devices; isolation comes from per-Database state), so
"supervision" is lifecycle management rather than babysitting PIDs. The
status registry is a JSON file in the farm root (msabaoth's status-file
scheme, common/utils/msabaoth.h:78-87).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

from .server import Client, Server
from .storage import Database

__all__ = ["Farm", "Funnel"]


def _splice(a, b) -> None:
    """Bidirectional byte relay between two sockets until either side
    closes (proxy.c's connection splice)."""
    import socket

    def pump(src, dst):
        try:
            while True:
                data = src.recv(1 << 16)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    t = threading.Thread(target=pump, args=(b, a), daemon=True)
    t.start()
    pump(a, b)
    t.join(timeout=5)
    try:
        b.close()
    except OSError:
        pass


class Farm:
    """A directory of named databases, each startable as a network server
    (monetdbd's dbfarm; `monetdb create/start/stop/status/snapshot`)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._servers: Dict[str, Server] = {}
        self._dbs: Dict[str, Database] = {}
        self._mu = threading.RLock()
        self._restarts: Dict[str, List[float]] = {}
        self._crashed: Dict[str, bool] = {}
        self._sup_stop: Optional[threading.Event] = None
        self._sup_thread: Optional[threading.Thread] = None
        # discovery (discoveryrunner.c): dbname → (host, port, last_seen)
        self.neighbors: Dict[str, tuple] = {}
        self._disc_sock = None
        self._disc_stop: Optional[threading.Event] = None
        self._disc_threads: List[threading.Thread] = []
        self._disc_port: Optional[int] = None
        self._proxy_srv = None

    # -- db lifecycle -----------------------------------------------------
    def _dbdir(self, name: str) -> str:
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"bad database name {name!r}")
        return os.path.join(self.root, name)

    def create(self, name: str) -> None:
        d = self._dbdir(name)
        if os.path.exists(d):
            raise ValueError(f"database {name} exists")
        db = Database(d)
        db.checkpoint()
        db.close()
        self._write_status()

    def destroy(self, name: str) -> None:
        with self._mu:
            if name in self._servers:
                raise ValueError(f"database {name} is running")
            shutil.rmtree(self._dbdir(name))
            self._dbs.pop(name, None)
        self._write_status()

    def databases(self) -> List[str]:
        return sorted(n for n in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, n))
                      and not n.startswith("."))

    # -- server lifecycle (forkmserver.c analog) --------------------------
    def start(self, name: str, port: int = 0) -> Tuple[str, int]:
        with self._mu:
            if name in self._servers:
                return self._servers[name].address
            if not os.path.isdir(self._dbdir(name)):
                raise ValueError(f"unknown database {name}")
            db = Database(self._dbdir(name))
            srv = Server(db, port=port).start()
            self._dbs[name] = db
            self._servers[name] = srv
            self._write_status()
            return srv.address

    def stop(self, name: str) -> None:
        with self._mu:
            srv = self._servers.pop(name, None)
            if srv is None:
                return
            srv.stop()
            db = self._dbs.pop(name)
            db.checkpoint()
            db.close()
            self._write_status()

    def stop_all(self) -> None:
        self.stop_supervisor()
        self.proxy_stop()
        self.disable_discovery()
        for name in list(self._servers):
            self.stop(name)

    # -- supervision (forkmserver.c:189: monetdbd babysits mservers and
    # restarts them on crash; here servers are threads, so "crash" = the
    # accept loop dying, and restart = reopen the Database - which runs
    # WAL replay / manifest recovery - and relisten on the same port) ----
    def supervise(self, interval: float = 0.5, max_restarts: int = 5,
                  window: float = 60.0) -> None:
        """Start the babysitter thread: dead servers are restarted, with
        a crash-loop budget of max_restarts per window seconds (after
        which the database is marked 'crashed' and left down, like
        merovingian giving up on a flapping mserver)."""
        with self._mu:
            if self._sup_thread is not None:
                return
            self._sup_stop = threading.Event()
            self._sup_thread = threading.Thread(
                target=self._sup_loop,
                args=(interval, max_restarts, window), daemon=True)
            self._sup_thread.start()

    def stop_supervisor(self) -> None:
        with self._mu:
            stop, t = self._sup_stop, self._sup_thread
            self._sup_stop = self._sup_thread = None
        if stop is not None:
            stop.set()
            t.join(timeout=5)

    def _sup_loop(self, interval: float, max_restarts: int,
                  window: float) -> None:
        while True:
            stop = self._sup_stop
            if stop is None or stop.wait(interval):
                return
            self.check_once(max_restarts, window)

    def check_once(self, max_restarts: int = 5,
                   window: float = 60.0) -> List[str]:
        """One supervision sweep; returns the names restarted."""
        restarted = []
        with self._mu:
            for name, srv in list(self._servers.items()):
                if srv.alive:
                    continue
                hist = self._restarts.setdefault(name, [])
                now = time.time()
                hist[:] = [t for t in hist if now - t < window]
                host, port = srv.address
                try:
                    srv.stop()
                except Exception:
                    pass
                self._servers.pop(name, None)
                old_db = self._dbs.pop(name, None)
                if old_db is not None:
                    try:
                        old_db.close()
                    except Exception:
                        pass
                if len(hist) >= max_restarts:
                    self._crashed[name] = True   # flapping: give up
                    self._write_status()
                    continue
                hist.append(now)
                db = Database(self._dbdir(name))   # WAL replay recovery
                self._dbs[name] = db
                self._servers[name] = Server(db, host=host,
                                             port=port).start()
                self._crashed.pop(name, None)
                restarted.append(name)
            if restarted:
                self._write_status()
        return restarted

    def db(self, name: str) -> Database:
        """In-process handle of a running database (embedded access)."""
        with self._mu:
            if name not in self._dbs:
                raise ValueError(f"database {name} is not running")
            return self._dbs[name]

    # -- status registry (sabaoth files) ----------------------------------
    def status(self) -> List[dict]:
        out = []
        with self._mu:
            for name in self.databases():
                srv = self._servers.get(name)
                state = "running" if srv else (
                    "crashed" if self._crashed.get(name) else "stopped")
                ent = {"name": name, "state": state}
                if srv:
                    ent["host"], ent["port"] = srv.address
                if self._restarts.get(name):
                    ent["restarts"] = len(self._restarts[name])
                out.append(ent)
        # discovered remote databases (discoveryrunner.c neighbor list)
        for name, (host, port, _ts) in sorted(self.neighbors.items()):
            out.append({"name": name, "state": "remote",
                        "host": host, "port": port})
        return out

    def _write_status(self) -> None:
        tmp = os.path.join(self.root, ".status.json.new")
        with open(tmp, "w") as f:
            json.dump({"ts": time.time(), "dbs": self.status()}, f)
        os.replace(tmp, os.path.join(self.root, ".status.json"))

    # -- snapshots (daemon/snapshot.c) ------------------------------------
    def snapshot(self, name: str, tar_path: str) -> None:
        with self._mu:
            db = self._dbs.get(name)
            if db is not None:
                db.snapshot(tar_path)
                return
        db = Database(self._dbdir(name))
        try:
            db.snapshot(tar_path)
        finally:
            db.close()

    def restore(self, name: str, tar_path: str) -> None:
        with self._mu:
            if name in self._servers:
                raise ValueError(f"stop {name} before restoring")
            d = self._dbdir(name)
            if os.path.exists(d):
                shutil.rmtree(d)
            Database.restore(tar_path, d).close()
        self._write_status()

    # -- neighbor discovery (tools/merovingian/daemon/discoveryrunner.c:
    # UDP HELO/ANNC/LEAV broadcasts; here JSON datagrams on a shared
    # localhost port with SO_REUSEPORT so several farms on one host —
    # the reference's multi-daemon test topology — hear each other) -----
    #: loopback multicast group for discovery datagrams — every farm on
    #: the host that joined the group receives each announcement (the
    #: reference broadcasts on the LAN, discoveryrunner.c:40)
    _DISC_GROUP = "239.254.77.77"

    def enable_discovery(self, port: int = 50001,
                         interval: float = 0.5) -> None:
        import socket
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind(("", port))
        mreq = socket.inet_aton(self._DISC_GROUP) + \
            socket.inet_aton("127.0.0.1")
        s.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_IF,
                     socket.inet_aton("127.0.0.1"))
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        s.settimeout(0.2)
        self._disc_sock = s
        self._disc_port = port
        self._disc_stop = threading.Event()

        def announce_loop():
            while not self._disc_stop.is_set():
                self._announce("ANNC")
                self._disc_stop.wait(interval)

        def listen_loop():
            import socket as _s
            while not self._disc_stop.is_set():
                try:
                    data, _addr = s.recvfrom(65536)
                except (_s.timeout, OSError):
                    continue
                try:
                    msg = json.loads(data.decode())
                except ValueError:
                    continue
                if msg.get("farm") == id(self):
                    continue                     # own broadcast
                if msg.get("op") == "LEAV":
                    self.neighbors.pop(msg.get("db", ""), None)
                elif msg.get("op") == "ANNC":
                    h, p = msg.get("addr", (None, 0))
                    if h:
                        self.neighbors[msg["db"]] = (h, int(p),
                                                     time.time())

        for fn in (announce_loop, listen_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._disc_threads.append(t)

    def _announce(self, op: str) -> None:
        if self._disc_sock is None:
            return
        with self._mu:
            items = [(n, srv.address) for n, srv in self._servers.items()]
        for name, (host, port) in items:
            try:
                self._disc_sock.sendto(
                    json.dumps({"op": op, "db": name,
                                "addr": [host, port],
                                "farm": id(self)}).encode(),
                    (self._DISC_GROUP, self._disc_port))
            except OSError:
                pass

    def disable_discovery(self) -> None:
        if self._disc_stop is not None:
            self._announce("LEAV")
            self._disc_stop.set()
            for t in self._disc_threads:
                t.join(timeout=2)
            self._disc_threads.clear()
            if self._disc_sock is not None:
                self._disc_sock.close()
                self._disc_sock = None

    # -- client proxy (tools/merovingian/daemon/proxy.c: one farm port
    # reaches every database; the daemon reads the client's database
    # selector, starts a local db on demand — forkmserver.c — or routes
    # to a discovered neighbor, then splices bytes both ways) ----------
    def proxy_listen(self, port: int = 0):
        import socket
        import socketserver
        farm = self

        class _ProxyHandler(socketserver.BaseRequestHandler):
            def handle(self):
                from .server import _recv_raw, _send
                try:
                    first = _recv_raw(self.request)
                except (ConnectionError, OSError):
                    return
                if first is None:
                    return
                try:
                    sel = json.loads(first.decode())
                except ValueError:
                    sel = {}
                name = sel.get("database")
                backend = farm._resolve_backend(name)
                if backend is None:
                    _send(self.request,
                          {"error": f"no such database '{name}'"})
                    return
                try:
                    up = socket.create_connection(backend)
                except OSError as ex:
                    _send(self.request, {"error": f"proxy: {ex}"})
                    return
                _splice(self.request, up)

        class _TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        srv = _TCP(("127.0.0.1", port), _ProxyHandler)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        self._proxy_srv = srv
        return srv.server_address

    def _resolve_backend(self, name):
        """Database name → (host, port): running local server, else
        on-demand local start (forkmserver.c), else discovered
        neighbor."""
        if not name:
            return None
        with self._mu:
            srv = self._servers.get(name)
            if srv is not None:
                return srv.address
        if os.path.isdir(os.path.join(self.root, name)):
            return self.start(name)
        nb = self.neighbors.get(name)
        if nb is not None:
            return (nb[0], nb[1])
        return None

    def proxy_stop(self) -> None:
        if self._proxy_srv is not None:
            self._proxy_srv.shutdown()
            self._proxy_srv.server_close()
            self._proxy_srv = None

    def funnel(self, names: List[str]) -> "Funnel":
        addrs = [self.start(n) for n in names]
        return Funnel(addrs)


class Funnel:
    """Multiplex-funnel (daemon/multiplex-funnel.c): one logical session
    fanned out to N databases; SELECT results are concatenated, DML is
    broadcast and affected-counts summed."""

    def __init__(self, addrs: List[Tuple[str, int]],
                 user: Optional[str] = None,
                 password: Optional[str] = None):
        self.clients = [Client(h, p, user, password) for h, p in addrs]

    def sql(self, text: str):
        from .engine import Result
        results = [c.sql(text) for c in self.clients]
        if all(isinstance(r, Result) for r in results):
            rows = [row for r in results for row in r.rows]
            return Result(results[0].names, results[0].types, rows)
        if all(isinstance(r, int) for r in results):
            return sum(results)
        return None

    def close(self) -> None:
        for c in self.clients:
            c.close()
