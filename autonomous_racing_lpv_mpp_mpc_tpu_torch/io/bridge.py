"""ctypes bindings for the native IO bridge (``native/io_bridge.cpp``), the
JAX package's ``io/bridge.py`` over the same C ABI.

The controller process talks to a car or sensor process through lock-free
shared-memory seqlock channels (same host) or UDP (off-host), both
implemented in C++ with a C ABI. The Python side is a thin wrapper with no
allocation per frame: each handle allocates its buffers once and reuses
them, so the 30 Hz loop never touches the allocator. numpy and ctypes only:
frames are host data whichever device the controller runs on.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..utils.nativelib import NativeLibUnavailable, find_native_lib

_lib = None

DATA_LANES = 8


class BridgeUnavailable(RuntimeError):
    pass


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        path = find_native_lib("libiobridge.so", "libiobridge.so")
    except NativeLibUnavailable as e:
        raise BridgeUnavailable(str(e)) from e
    lib = ctypes.CDLL(path)
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_double_p = ctypes.POINTER(ctypes.c_double)

    lib.arl_monotonic.restype = ctypes.c_double
    lib.arl_bridge_create.restype = ctypes.c_void_p
    lib.arl_bridge_create.argtypes = [ctypes.c_char_p]
    lib.arl_bridge_open.restype = ctypes.c_void_p
    lib.arl_bridge_open.argtypes = [ctypes.c_char_p]
    lib.arl_bridge_close.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    for name in ("arl_write_state", "arl_write_control"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_double, c_float_p,
                       ctypes.c_int]
    for name in ("arl_read_state", "arl_read_control"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, c_double_p, c_float_p, ctypes.c_int]

    lib.arl_udp_socket.restype = ctypes.c_int
    lib.arl_udp_socket.argtypes = [ctypes.c_int]
    lib.arl_udp_send.restype = ctypes.c_int
    lib.arl_udp_send.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_double, c_float_p, ctypes.c_int]
    lib.arl_udp_recv_latest.restype = ctypes.c_int
    lib.arl_udp_recv_latest.argtypes = [
        ctypes.c_int, c_double_p, c_float_p, ctypes.c_int]
    lib.arl_udp_close.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def bridge_available() -> bool:
    try:
        _load()
        return True
    except BridgeUnavailable:
        return False


def monotonic() -> float:
    return float(_load().arl_monotonic())


class CarBridge:
    """Shared-memory state/control channel pair.

    The car side calls ``write_state``/``read_control``; the controller
    side calls ``read_state``/``write_control``. Reads are lock-free and
    return ``(frame_count, t, data)`` — ``frame_count`` increments per
    write, so callers detect both staleness (count unchanged) and drops
    (count jumped by more than one).
    """

    def __init__(self, name: str, create: bool = False):
        lib = _load()
        self._lib = lib
        self._name = name.encode()
        self._owner = create
        h = (lib.arl_bridge_create if create else lib.arl_bridge_open)(
            self._name)
        if not h:
            raise BridgeUnavailable(
                f"cannot {'create' if create else 'open'} shm bridge {name}")
        self._h = ctypes.c_void_p(h)
        self._t = ctypes.c_double(0.0)
        self._buf = np.zeros(DATA_LANES, np.float32)
        self._buf_p = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def close(self):
        if self._h:
            self._lib.arl_bridge_close(self._h, self._name,
                                       1 if self._owner else 0)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write_state(self, t: float, x: np.ndarray):
        n = min(len(x), DATA_LANES)
        self._buf[:n] = np.asarray(x, np.float32)[:n]
        self._lib.arl_write_state(self._h, float(t), self._buf_p, n)

    def read_state(self, nx: int) -> Tuple[int, float, np.ndarray]:
        cnt = self._lib.arl_read_state(self._h, ctypes.byref(self._t),
                                       self._buf_p, nx)
        return cnt, self._t.value, self._buf[:nx].copy()

    def write_control(self, t: float, u: np.ndarray):
        n = min(len(u), DATA_LANES)
        self._buf[:n] = np.asarray(u, np.float32)[:n]
        self._lib.arl_write_control(self._h, float(t), self._buf_p, n)

    def read_control(self, nu: int) -> Tuple[int, float, np.ndarray]:
        cnt = self._lib.arl_read_control(self._h, ctypes.byref(self._t),
                                         self._buf_p, nu)
        return cnt, self._t.value, self._buf[:nu].copy()


class UDPLink:
    """UDP frame endpoint (off-host car). ``recv_latest`` drains the socket
    and keeps only the newest frame — late packets are dropped, matching
    the control loop's freshest-state-wins semantics."""

    def __init__(self, port: int):
        lib = _load()
        self._lib = lib
        self._fd = lib.arl_udp_socket(port)
        if self._fd < 0:
            raise BridgeUnavailable(f"cannot bind UDP port {port}")
        self._t = ctypes.c_double(0.0)
        self._buf = np.zeros(DATA_LANES, np.float32)
        self._buf_p = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self.port = port

    def close(self):
        if self._fd >= 0:
            self._lib.arl_udp_close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def send(self, ip: str, port: int, count: int, t: float,
             data: np.ndarray) -> bool:
        n = min(len(data), DATA_LANES)
        self._buf[:n] = np.asarray(data, np.float32)[:n]
        r = self._lib.arl_udp_send(self._fd, ip.encode(), port, count,
                                   float(t), self._buf_p, n)
        return r == 0

    def recv_latest(self, n: int) -> Tuple[int, float, Optional[np.ndarray]]:
        cnt = self._lib.arl_udp_recv_latest(
            self._fd, ctypes.byref(self._t), self._buf_p, n)
        if cnt < 0:
            return -1, 0.0, None
        return cnt, self._t.value, self._buf[:n].copy()


class UDPBridge:
    """Off-host transport with the :class:`CarBridge` channel interface
    (``write_state``/``read_state``/``write_control``/``read_control``),
    so :func:`..realtime.realtime_tracking_loop` and the lockstep car run
    unchanged over UDP — the BARC deployment shape where the car's
    on-board computer is a different host from the GPU controller.

    Two sockets: states flow car -> controller on ``state_port``, controls
    controller -> car on ``control_port``. Frame counts are assigned by
    the sender (monotonic per writer, like the shm seqlock's count) and
    late datagrams lose to ``recv_latest``'s freshest-frame draining.
    """

    def __init__(self, role: str, peer_ip: str = "127.0.0.1",
                 state_port: int = 47401, control_port: int = 47402):
        if role not in ("car", "controller"):
            raise ValueError(f"role must be car|controller, got {role!r}")
        self.role = role
        self._peer_ip = peer_ip
        self._state_port = state_port
        self._control_port = control_port
        # each side binds the port it LISTENS on
        self._rx = UDPLink(control_port if role == "car" else state_port)
        self._tx_count = 0
        # last frame seen: socket drains are destructive, but the channel
        # contract (same as the shm seqlock) is idempotent
        # latest-frame reads — so cache and re-serve it
        self._last = (0, 0.0, None)

    def close(self):
        self._rx.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _send(self, port: int, t: float, data: np.ndarray):
        self._tx_count += 1
        self._rx.send(self._peer_ip, port, self._tx_count, t, data)

    def _role(self, want: str):
        if self.role != want:
            raise RuntimeError(f"a {self.role!r} bridge cannot do what only the {want!r} side does")

    def write_state(self, t: float, x: np.ndarray):
        self._role("car")
        self._send(self._state_port, t, x)

    def _read(self, n: int) -> Tuple[int, float, np.ndarray]:
        cnt, t, data = self._rx.recv_latest(n)
        if data is not None and cnt > self._last[0]:
            self._last = (cnt, t, data)
        cnt, t, data = self._last
        if data is None:
            return 0, 0.0, np.zeros(n, np.float32)
        return cnt, t, data[:n]

    def read_state(self, nx: int) -> Tuple[int, float, np.ndarray]:
        self._role("controller")
        return self._read(nx)

    def write_control(self, t: float, u: np.ndarray):
        self._role("controller")
        self._send(self._control_port, t, u)

    def read_control(self, nu: int) -> Tuple[int, float, np.ndarray]:
        self._role("car")
        return self._read(nu)
