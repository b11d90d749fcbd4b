"""Host-side offload thread pools.

The port of ``torchmpi_tpu/runtime/pools.py``: the reference's two
dedicated pools, one for collective offload and one for parameter-server
client ops (``lib/resources.cpp:399-461``, ``lib/thread_pool-in.h``), each
a ``ThreadPoolExecutor`` sized by its constant and made at first use.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

from .. import constants


class _Pool:
    def __init__(self, name: str, size_constant: str):
        self._name = name
        self._size_constant = size_constant
        self._executor: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()

    def _get(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=constants.get(self._size_constant),
                    thread_name_prefix=self._name,
                )
            return self._executor

    def submit(self, fn: Callable, /, *args, **kwargs) -> Future:
        return self._get().submit(fn, *args, **kwargs)

    def shutdown(self) -> None:
        # detach under the lock, join outside it: a worker that submits
        # (-> _get -> self._lock) while the join holds the lock would
        # deadlock the teardown
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=True)


collective_pool = _Pool("tm-collective", "collective_thread_pool_size")
parameterserver_pool = _Pool("tm-ps", "parameterserver_thread_pool_size")


def shutdown_all() -> None:
    collective_pool.shutdown()
    parameterserver_pool.shutdown()
