"""FileStore — a TCPStore-API-compatible KV over a shared directory.

The fleet's heartbeat/rendezvous state needs a store every replica
process can reach. The native TCPStore (runtime/csrc/tcp_store.cc) works
but requires the C++ runtime build; a serving fleet on one box (and
every CPU-mesh test/drill in this repo) already shares a filesystem —
the same substrate the checkpoint commit barrier trusts
(checkpoint.post_progress's atomic progress files). FileStore speaks the
same four verbs (get/set/add/wait) with the same failure surface
(KeyError for a missing key, TimeoutError from a bounded wait), so the
fault injectors built for TCPStore-like objects (faults.WedgedStore,
faults.HeartbeatBlackout) wrap it unchanged.

Writes are atomic (tmp + fsync + os.replace — the LATEST-pointer idiom),
so a reader never observes a torn value; ``add`` serializes through an
O_EXCL lock file so concurrent counters don't lose increments.

Beyond the original four verbs, the fleet prefix store needs
lifecycle verbs, all TCPStore-shaped where TCPStore has them:

- ``delete_key(key)`` — remove a key (GC of spilled KV pages);
- ``compare_set(key, expected, desired)`` — atomic compare-and-swap
  (``expected=""`` means set-if-absent: safe spill OWNERSHIP — two
  replicas evicting the same chain page race to one winner instead of
  rewriting each other);
- ``keys(prefix)`` / ``sweep_expired(prefix, ttl_s)`` — enumerate and
  TTL-expire a key namespace by write time (mtime of the atomic
  replace), the prefix-store GC primitive.
"""

from __future__ import annotations

import os
import time


class FileStore:
    """Directory-backed store: one file per key under ``root``."""

    def __init__(self, root, timeout=30.0):
        self.root = os.path.abspath(root)
        self.timeout = timeout
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key):
        # keys are hierarchical ("serve/hb/r0"); flatten to one level so
        # a key can never escape the root or collide with a directory.
        # Percent-encoding (safe="") is INVERTIBLE for every key — a
        # separator-substitution scheme ("/" -> "__") would decode keys
        # that themselves contain "__" to the wrong name, making them
        # invisible to keys()/sweep_expired() GC and collidable
        from urllib.parse import quote
        return os.path.join(self.root, "k__" + quote(str(key), safe=""))

    @staticmethod
    def _unpath(fname):
        from urllib.parse import unquote
        return unquote(fname[len("k__"):])

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        p = self._path(key)
        # unique per WRITER, not per process: two threads of one process
        # sharing a pid-only tmp name could truncate each other mid-write
        # and publish a torn value through the other's os.replace
        import threading
        tmp = p + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(value)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def get(self, key):
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def add(self, key, amount):
        """Atomic counter increment; returns the new value. ``add(k, 0)``
        reads the counter (TCPStore semantics)."""
        lock = self._path(key) + ".lock"
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                break
            except FileExistsError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"FileStore.add({key!r}): lock {lock} held past "
                        f"{self.timeout}s (stale lock from a killed "
                        "process? remove it to recover)") from None
                time.sleep(0.005)
        try:
            try:
                cur = int(self.get(key))
            except (KeyError, ValueError):
                cur = 0
            cur += int(amount)
            self.set(key, str(cur))
            return cur
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass

    def delete_key(self, key):
        """Remove `key`; True if it existed (TCPStore.delete_key)."""
        try:
            os.unlink(self._path(key))
            return True
        except FileNotFoundError:
            return False

    def compare_set(self, key, expected, desired):
        """Atomic compare-and-swap (TCPStore.compare_set semantics):
        set `key` to `desired` iff its current value equals `expected`
        (``expected=""``/``b""`` matches a MISSING key — set-if-absent).
        Returns the value the key holds AFTER the call, so the caller
        learns whether it won (== desired) or who did. Serialized
        through the same O_EXCL lock ``add`` uses."""
        if isinstance(expected, str):
            expected = expected.encode()
        if isinstance(desired, str):
            desired = desired.encode()
        lock = self._path(key) + ".lock"
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                break
            except FileExistsError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"FileStore.compare_set({key!r}): lock {lock} "
                        f"held past {self.timeout}s") from None
                time.sleep(0.005)
        try:
            try:
                cur = self.get(key)
            except KeyError:
                cur = b""
            if cur == expected:
                self.set(key, desired)
                return desired
            return cur
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass

    def keys(self, prefix=""):
        """Every stored key starting with `prefix` (GC enumeration)."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not name.startswith("k__") or name.endswith(".lock") \
                    or ".tmp." in name:
                continue
            key = self._unpath(name)
            if key.startswith(prefix):
                out.append(key)
        return sorted(out)

    def sweep_expired(self, prefix, ttl_s):
        """Delete every key under `prefix` whose last write (the atomic
        replace's mtime) is older than `ttl_s` seconds — the prefix
        store's GC verb. Returns the number of keys removed. A key
        rewritten after our stat simply survives (its mtime moved)."""
        removed = 0
        now = time.time()
        for key in self.keys(prefix):
            p = self._path(key)
            try:
                if now - os.stat(p).st_mtime > ttl_s:
                    os.unlink(p)
                    removed += 1
            except OSError:
                continue        # deleted/rewritten under us: not ours
        return removed

    def wait(self, keys, timeout=None):
        if isinstance(keys, str):
            keys = [keys]
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.timeout)
        for k in keys:
            while True:
                try:
                    self.get(k)
                    break
                except KeyError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"FileStore.wait({k!r}) timed out") from None
                    time.sleep(0.01)

    def close(self):
        pass
