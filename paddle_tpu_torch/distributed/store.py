"""``TCPStore``: the counterpart of ``paddle.distributed.TCPStore`` and of
the JAX package's native store (``paddle_tpu/runtime/__init__.py:298-380``,
``TCPStore(host, port, is_master, world_size, timeout)`` with ``.port``,
``set``, ``get``, ``add``, ``wait``).

It wraps ``torch.distributed.TCPStore``, the store that
``torch.distributed.init_process_group`` meets its ranks at
(``torch_store``), under the JAX API:

- ``get`` of a missing key raises ``KeyError`` at once (torch's blocks
  until the key appears), asked through ``check``;
- ``wait(keys, timeout=None)``: without a timeout it waits as long as the
  store's own `timeout`; either way a key that never comes raises
  ``TimeoutError``;
- a master with ``port=0`` listens on a free port, which ``.port`` gives.

``host``, ``port`` and ``check`` are there for ``fleet.elastic``, which
reconnects to the same endpoint.
"""

from __future__ import annotations

import datetime


class TCPStore:
    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=30.0):
        from torch.distributed import TCPStore as _TorchStore
        self.host = host
        self.world_size = world_size
        self.timeout = float(timeout)
        # the master does not wait for the others to connect (the JAX
        # store's master does not either); init_process_group does
        self._s = _TorchStore(host, int(port), None, bool(is_master),
                              datetime.timedelta(seconds=self.timeout),
                              wait_for_workers=False)
        self.port = int(self._s.port)
        # a master's object runs the server; fleet.elastic hands it on to
        # the client that replaces this one
        self._server = self._s if is_master else None

    @property
    def torch_store(self):
        """The ``torch.distributed.TCPStore`` itself."""
        return self._s

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        self._s.set(key, value)

    def check(self, keys):
        return self._s.check(list(keys))

    def get(self, key):
        if not self._s.check([key]):
            raise KeyError(key)
        return bytes(self._s.get(key))

    def add(self, key, amount):
        return int(self._s.add(key, int(amount)))

    def wait(self, keys, timeout=None):
        """Block until every key of `keys` (a key or a list) exists;
        ``TimeoutError`` after `timeout` seconds (the store's timeout when
        None)."""
        if isinstance(keys, str):
            keys = [keys]
        secs = self.timeout if timeout is None else float(timeout)
        try:
            self._s.wait(list(keys), datetime.timedelta(seconds=secs))
        except RuntimeError as e:        # torch's DistStoreError
            raise TimeoutError(f"store.wait({keys!r}) timed out after "
                               f"{secs}s") from e

    def num_keys(self):
        return int(self._s.num_keys())

    def delete_key(self, key):
        return bool(self._s.delete_key(key))

    def close(self):
        """Drop the connection (a master's server stops with it)."""
        self._s = None
        self._server = None
