"""Batched UDP syscalls: ``recvmmsg(2)``/``sendmmsg(2)`` via ctypes,
with portable fallbacks.

Port of ``veneur_tpu/ingest/recvmmsg.py``. Standard library only, so a
load generator can import this file by path without importing torch.

The reference's reader loop costs one ``recvfrom`` syscall per datagram
(socket_linux.go:55-76); at millions of packets per second the syscall
boundary is a measurable fraction of the reader core. ``recvmmsg``
drains up to ``batch`` datagrams per syscall into preallocated buffers.
On platforms without it (or non-Linux libc layouts) the receiver
degrades to a nonblocking ``recv`` loop — still one syscall per
datagram, same interface. ``BatchSender`` is the mirror image for load
generators (``chip_smoke.py``'s ingest senders): without it a Python
``send()`` loop saturates its core long before the lanes do, and a
measurement measures the sender, not the fleet.

Counters (``syscalls``, ``packets``) are single-writer plain ints (one
receiver per reader thread); the fleet reports the syscalls-per-packet
ratio from them.
"""

from __future__ import annotations

import ctypes
import errno
import os
import select
import socket
import sys
from typing import List

_MSG_DONTWAIT = 0x40  # Linux

_libc = None
_libc_checked = False


class _IoVec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p),
                ("iov_len", ctypes.c_size_t)]


class _MsgHdr(ctypes.Structure):
    _fields_ = [("msg_name", ctypes.c_void_p),
                ("msg_namelen", ctypes.c_uint),
                ("msg_iov", ctypes.POINTER(_IoVec)),
                ("msg_iovlen", ctypes.c_size_t),
                ("msg_control", ctypes.c_void_p),
                ("msg_controllen", ctypes.c_size_t),
                ("msg_flags", ctypes.c_int)]


class _MMsgHdr(ctypes.Structure):
    _fields_ = [("msg_hdr", _MsgHdr),
                ("msg_len", ctypes.c_uint)]


def _load_libc():
    global _libc, _libc_checked
    if _libc_checked:
        return _libc
    _libc_checked = True
    if not sys.platform.startswith("linux"):
        return None
    try:
        lib = ctypes.CDLL(None, use_errno=True)
        fn = lib.recvmmsg
    except (OSError, AttributeError):
        return None
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(_MMsgHdr), ctypes.c_uint,
                   ctypes.c_int, ctypes.c_void_p]
    _libc = lib
    return _libc


def recvmmsg_available() -> bool:
    return _load_libc() is not None


_sendmmsg = None
_sendmmsg_checked = False


def _load_sendmmsg():
    global _sendmmsg, _sendmmsg_checked
    if _sendmmsg_checked:
        return _sendmmsg
    _sendmmsg_checked = True
    lib = _load_libc()
    if lib is None:
        return None
    try:
        fn = lib.sendmmsg
    except AttributeError:
        return None
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(_MMsgHdr), ctypes.c_uint,
                   ctypes.c_int]
    _sendmmsg = fn
    return _sendmmsg


class BatchReceiver:
    """Drains one UDP socket in datagram batches.

    ``recv_batch(timeout)`` waits (``poll``, GIL released) up to
    ``timeout`` for readability, then pulls up to ``batch`` datagrams in
    ONE ``recvmmsg`` syscall (``MSG_DONTWAIT`` — the poll already
    proved readability, and a racing consumer is impossible: one
    receiver per socket). Returns ``[]`` on timeout. OSErrors propagate
    for the caller's rate-limited logging."""

    __slots__ = ("sock", "batch", "syscalls", "packets", "_libc", "_fd",
                 "_bufs", "_iovecs", "_msgs", "_max_len", "_poller")

    def __init__(self, sock: socket.socket, max_len: int, batch: int = 32,
                 force_fallback: bool = False):
        self.sock = sock
        self.batch = max(1, batch)
        self.syscalls = 0
        self.packets = 0
        self._max_len = max_len
        self._fd = sock.fileno()
        # poll, not select: select.select raises ValueError for any fd
        # >= FD_SETSIZE (1024), a cap a server with many TCP/TLS
        # connections crosses in normal operation
        self._poller = select.poll()
        self._poller.register(self._fd, select.POLLIN)
        self._libc = None if force_fallback else _load_libc()
        if self._libc is not None:
            self._bufs = [ctypes.create_string_buffer(max_len)
                          for _ in range(self.batch)]
            self._iovecs = (_IoVec * self.batch)()
            self._msgs = (_MMsgHdr * self.batch)()
            for i in range(self.batch):
                self._iovecs[i].iov_base = ctypes.cast(self._bufs[i],
                                                       ctypes.c_void_p)
                self._iovecs[i].iov_len = max_len
                hdr = self._msgs[i].msg_hdr
                hdr.msg_iov = ctypes.pointer(self._iovecs[i])
                hdr.msg_iovlen = 1
        else:
            # fallback: nonblocking recv loop, one syscall per datagram
            sock.setblocking(False)

    @property
    def using_recvmmsg(self) -> bool:
        return self._libc is not None

    def recv_batch(self, timeout: float = 0.2) -> List[bytes]:
        if not self._poller.poll(max(0, int(timeout * 1000))):
            return []
        if self._libc is not None:
            return self._recv_mmsg()
        return self._recv_fallback()

    def _recv_mmsg(self) -> List[bytes]:
        n = self._libc.recvmmsg(self._fd, self._msgs, self.batch,
                                _MSG_DONTWAIT, None)
        self.syscalls += 1
        if n <= 0:
            err = ctypes.get_errno()
            if err in (errno.EAGAIN, errno.EWOULDBLOCK, errno.EINTR) \
                    or n == 0:
                return []
            raise OSError(err, os.strerror(err))
        self.packets += n
        out = []
        for i in range(n):
            ln = self._msgs[i].msg_len
            out.append(ctypes.string_at(
                ctypes.addressof(self._bufs[i]), ln))
        return out

    def _recv_fallback(self) -> List[bytes]:
        out: List[bytes] = []
        sock, max_len = self.sock, self._max_len
        for _ in range(self.batch):
            try:
                data = sock.recv(max_len)
            except (BlockingIOError, InterruptedError):
                break
            self.syscalls += 1
            if data:
                out.append(data)
        self.packets += len(out)
        return out


class BatchSender:
    """Sends a FIXED cycle of datagrams on one connected UDP socket,
    whole cycle per ``sendmmsg`` syscall (``send`` loop fallback).

    The headers and iovecs are prebuilt once from ``payloads`` — each
    ``send_cycle()`` is one syscall and zero Python per-datagram work,
    which is what lets a 2-process load generator outrun an N-lane
    fleet instead of the other way around. A short send (kernel buffer
    full) just means those datagrams are dropped on the floor — UDP
    load-generator semantics, counted in ``packets`` as actually sent.
    """

    __slots__ = ("sock", "payloads", "syscalls", "packets", "_fn",
                 "_fd", "_bufs", "_iovecs", "_msgs", "_n")

    def __init__(self, sock: socket.socket, payloads: List[bytes]):
        self.sock = sock
        self.payloads = payloads
        self.syscalls = 0
        self.packets = 0
        self._fd = sock.fileno()
        self._n = len(payloads)
        self._fn = _load_sendmmsg()
        if self._fn is not None:
            self._bufs = [ctypes.create_string_buffer(p, len(p))
                          for p in payloads]
            self._iovecs = (_IoVec * self._n)()
            self._msgs = (_MMsgHdr * self._n)()
            for i, p in enumerate(payloads):
                self._iovecs[i].iov_base = ctypes.cast(self._bufs[i],
                                                       ctypes.c_void_p)
                self._iovecs[i].iov_len = len(p)
                hdr = self._msgs[i].msg_hdr
                hdr.msg_iov = ctypes.pointer(self._iovecs[i])
                hdr.msg_iovlen = 1

    @property
    def using_sendmmsg(self) -> bool:
        return self._fn is not None

    def send_cycle(self) -> int:
        if self._fn is not None:
            n = self._fn(self._fd, self._msgs, self._n, 0)
            self.syscalls += 1
            if n < 0:
                err = ctypes.get_errno()
                if err in (errno.EAGAIN, errno.EWOULDBLOCK, errno.EINTR,
                           errno.ENOBUFS, errno.ECONNREFUSED):
                    return 0
                raise OSError(err, os.strerror(err))
            self.packets += n
            return n
        sent = 0
        for p in self.payloads:
            try:
                self.sock.send(p)
            except (BlockingIOError, InterruptedError,
                    ConnectionRefusedError):
                continue
            self.syscalls += 1
            sent += 1
        self.packets += sent
        return sent
