"""Remote dataset access (reference's ``dataset.remote`` flag).

The port's own copy of ``uavdet_tpu/data/remote.py``, with one change: a
filesystem hands out a file's bytes (``read_bytes``) instead of a decoded
image, because the frame stage decodes (``data/frames.py``: PIL on the CPU,
nvJPEG on the card, where PIL is absent). The surface is
{list_dir, isdir, exists, load_json, read_bytes}; backends:

* ``SFTPFileSystem``   — paramiko (gated import) with
  SFTP_HOST/PORT/USERNAME/PASSWORD from the environment or a .env file.
  The transport is injectable (tests drive it with an in-memory fake).
* ``FsspecFileSystem`` — any fsspec protocol (memory://, s3://, ...).
* ``GCSFileSystem``    — gs:// paths, a thin fsspec specialization over
  gcsfs.
"""

import json
import os


def _load_dotenv(path: str = ".env"):
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#") and "=" in line:
                k, v = line.split("=", 1)
                os.environ.setdefault(k.strip(), v.strip())


class SFTPFileSystem:
    """SFTP-backed dataset filesystem (reference connect_sftp,
    dataset/_helper.py:85-110).

    ``sftp``/``client`` inject a ready transport (tests use an in-memory
    fake with the paramiko SFTPClient surface: listdir/stat/open); when
    omitted, a paramiko connection is opened from the .env credentials.
    """

    def __init__(self, sftp=None, client=None):
        if sftp is not None:
            self._client = client
            self._sftp = sftp
            return
        try:
            import paramiko
        except ImportError as e:
            raise RuntimeError(
                "dataset.remote=true needs paramiko (not available in this "
                "environment); install it or use a GCS path") from e
        _load_dotenv()
        client = paramiko.SSHClient()
        client.set_missing_host_key_policy(paramiko.AutoAddPolicy())
        client.connect(
            hostname=os.environ["SFTP_HOST"],
            port=int(os.environ.get("SFTP_PORT", 22)),
            username=os.environ["SFTP_USERNAME"],
            password=os.environ["SFTP_PASSWORD"])
        self._client = client
        self._sftp = client.open_sftp()

    def list_dir(self, path):
        return sorted(self._sftp.listdir(path))

    def isdir(self, path):
        import stat
        try:
            return stat.S_ISDIR(self._sftp.stat(path).st_mode)
        except IOError:
            return False

    def exists(self, path):
        try:
            self._sftp.stat(path)
            return True
        except IOError:
            return False

    def read_bytes(self, path) -> bytes:
        with self._sftp.open(path, "rb") as f:
            f.prefetch()
            return f.read()

    def load_json(self, path):
        return json.loads(self.read_bytes(path))

    def close(self):
        self._sftp.close()
        if self._client is not None:
            self._client.close()


class FsspecFileSystem:
    """Dataset filesystem over any fsspec implementation.

    ``fs`` is an fsspec filesystem object; ``strip`` is a URL prefix
    removed from incoming paths (e.g. 'gs://' or 'memory://')."""

    def __init__(self, fs, strip: str = ""):
        self._fs = fs
        self._strip = strip

    def _p(self, path: str) -> str:
        return path[len(self._strip):] if self._strip and \
            path.startswith(self._strip) else path

    def list_dir(self, path):
        return sorted(os.path.basename(p.rstrip("/"))
                      for p in self._fs.ls(self._p(path), detail=False))

    def isdir(self, path):
        return self._fs.isdir(self._p(path))

    def exists(self, path):
        return self._fs.exists(self._p(path))

    def load_json(self, path):
        with self._fs.open(self._p(path), "rb") as f:
            return json.load(f)

    def read_bytes(self, path) -> bytes:
        with self._fs.open(self._p(path), "rb") as f:
            return f.read()


class GCSFileSystem(FsspecFileSystem):
    """GCS-backed dataset filesystem."""

    def __init__(self):
        try:
            import gcsfs
        except ImportError as e:
            raise RuntimeError(
                "GCS remote access needs gcsfs (not available in this "
                "environment)") from e
        super().__init__(gcsfs.GCSFileSystem(), strip="gs://")


def make_filesystem(root_dir: str, remote: bool):
    """Pick the filesystem backend for a dataset root.

    gs:// → GCS; other URL schemes → the matching fsspec backend
    (memory:// serves as the in-CI remote stand-in); plain path with
    ``remote`` set → SFTP (reference semantics); else local (None)."""
    if root_dir.startswith("gs://"):
        return GCSFileSystem()
    if "://" in root_dir:
        import fsspec
        proto = root_dir.split("://", 1)[0]
        return FsspecFileSystem(fsspec.filesystem(proto),
                                strip=f"{proto}://")
    if remote:
        return SFTPFileSystem()
    return None


def read_bytes(path: str, fs=None) -> bytes:
    """A file's bytes, from ``fs`` or the local disk."""
    if fs is not None:
        return fs.read_bytes(path)
    with open(path, "rb") as f:
        return f.read()
