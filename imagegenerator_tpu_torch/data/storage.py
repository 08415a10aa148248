"""Blob storage adapters — the port's own copy of
``imagegenerator_tpu/data/storage.py``. A store is opened once and
shared across the loader's threads.

``open_store(url)`` dispatches on scheme:
  * ``gs://bucket[/prefix]``  -> GcsStore (lazy google-cloud import)
  * ``mem://name``            -> process-local MemoryStore (tests)
  * anything else             -> LocalStore rooted at that path
"""

from __future__ import annotations

import abc
import os
import threading


class BlobStore(abc.ABC):
    @abc.abstractmethod
    def read_bytes(self, path: str) -> bytes: ...

    @abc.abstractmethod
    def write_bytes(self, path: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def exists(self, path: str) -> bool: ...

    @abc.abstractmethod
    def listdir(self, prefix: str) -> list[str]: ...

    def read_text(self, path: str) -> str:
        return self.read_bytes(path).decode("utf-8")

    def write_text(self, path: str, text: str) -> None:
        self.write_bytes(path, text.encode("utf-8"))


class LocalStore(BlobStore):
    def __init__(self, root: str = "."):
        self.root = root

    def _p(self, path: str) -> str:
        return os.path.join(self.root, path)

    def read_bytes(self, path: str) -> bytes:
        with open(self._p(path), "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        full = self._p(path)
        os.makedirs(os.path.dirname(full) or ".", exist_ok=True)
        tmp = full + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, full)  # atomic publish

    def exists(self, path: str) -> bool:
        return os.path.exists(self._p(path))

    def listdir(self, prefix: str) -> list[str]:
        full = self._p(prefix)
        if not os.path.isdir(full):
            return []
        return sorted(os.listdir(full))


_MEMORY_STORES: dict[str, "MemoryStore"] = {}
_MEMORY_LOCK = threading.Lock()


class MemoryStore(BlobStore):
    """In-memory blob store: the tests' stand-in for a bucket."""

    def __init__(self):
        self._blobs: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def read_bytes(self, path: str) -> bytes:
        with self._lock:
            if path not in self._blobs:
                raise FileNotFoundError(path)
            return self._blobs[path]

    def write_bytes(self, path: str, data: bytes) -> None:
        with self._lock:
            self._blobs[path] = bytes(data)

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._blobs

    def listdir(self, prefix: str) -> list[str]:
        prefix = prefix.rstrip("/") + "/" if prefix else ""
        with self._lock:
            names = {
                p[len(prefix):].split("/")[0]
                for p in self._blobs
                if p.startswith(prefix)
            }
        return sorted(names)


class GcsStore(BlobStore):
    """GCS-backed store; one client for the process. ``google.cloud`` is
    imported only when a store is built."""

    def __init__(self, bucket_name: str, prefix: str = ""):
        from google.cloud import storage  # deferred: needs credentials

        self._bucket = storage.Client().get_bucket(bucket_name)
        self._prefix = prefix.strip("/")

    def _p(self, path: str) -> str:
        return f"{self._prefix}/{path}" if self._prefix else path

    def read_bytes(self, path: str) -> bytes:
        return self._bucket.blob(self._p(path)).download_as_bytes()

    def write_bytes(self, path: str, data: bytes) -> None:
        self._bucket.blob(self._p(path)).upload_from_string(data)

    def exists(self, path: str) -> bool:
        return self._bucket.blob(self._p(path)).exists()

    def listdir(self, prefix: str) -> list[str]:
        full = self._p(prefix).rstrip("/") + "/"
        names = set()
        for blob in self._bucket.list_blobs(prefix=full):
            names.add(blob.name[len(full):].split("/")[0])
        return sorted(names)


def open_store(url: str) -> BlobStore:
    if url.startswith("gs://"):
        rest = url[len("gs://"):]
        bucket, _, prefix = rest.partition("/")
        return GcsStore(bucket, prefix)
    if url.startswith("mem://"):
        name = url[len("mem://"):]
        with _MEMORY_LOCK:
            if name not in _MEMORY_STORES:
                _MEMORY_STORES[name] = MemoryStore()
            return _MEMORY_STORES[name]
    return LocalStore(url)
