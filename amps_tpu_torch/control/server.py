"""TCP command server, the PyTorch port of ``amps_tpu.control.server``
-- the reference's Socket PDU operator interface (blocks_socket_pdu TCP
server, port 64652, MTU 10000, grc/ampsbs.grc:1650).

Text commands in ("page <MIN>", "fvc on/off/alert"), debug output back to
every connected client (the debug_output port).  asyncio; one server per
BaseStation.  The server runs no device work.  ``port=0`` binds a free
port, which ``port`` holds after ``start()``.
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Optional, Set

from amps_tpu_torch.control.station import BaseStation, StationEvent

DEFAULT_PORT = 64652


class CommandServer:
    def __init__(self, station: BaseStation, host: str = "127.0.0.1",
                 port: int = DEFAULT_PORT):
        self.station = station
        self.host = host
        self.port = port
        self._writers: Set[asyncio.StreamWriter] = set()
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # fan debug events out to connected operators
        prev = station._on_event

        def tee(ev: StationEvent):
            if prev:
                prev(ev)
            if ev.kind == "debug":
                self._broadcast(str(ev.payload))

        station._on_event = tee

    def _broadcast(self, msg: str) -> None:
        # newline-delimit every debug line (the reference's
        # debug_output port is line-oriented; station._debug messages
        # carry no trailing newline)
        data = (msg if msg.endswith("\n") else msg + "\n").encode()
        # station events can fire from the RX pipeline thread while the
        # server's event loop runs elsewhere; StreamWriter is NOT
        # thread-safe, so route foreign-thread writes through the loop
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is not loop:
                # the loop may close between is_closed() and this call: a
                # broadcast at shutdown is best effort, so the line is
                # dropped
                try:
                    loop.call_soon_threadsafe(self._write_all, data)
                except RuntimeError:
                    pass
                return
        self._write_all(data)

    def _write_all(self, data: bytes) -> None:
        for w in list(self._writers):
            try:
                w.write(data)
            except Exception:
                self._writers.discard(w)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        buf = b""
        try:
            while True:
                # a client dropping mid-read (reset, not FIN) is a normal
                # disconnect, not an error to leak to the event loop
                try:
                    data = await reader.read(10000)  # reference MTU
                except (ConnectionResetError, BrokenPipeError, OSError):
                    break
                if not data:
                    # EOF: flush a trailing unterminated command (a
                    # client may send 'page X' with no newline and
                    # half-close)
                    line = buf.decode(errors="replace").strip()
                    if line:
                        self.station.handle_command(line)
                    break
                # line-buffered framing: TCP segment boundaries are NOT
                # command boundaries -- a command split across two reads
                # must not execute as two broken commands
                buf += data
                while b"\n" in buf:
                    raw, buf = buf.split(b"\n", 1)
                    line = raw.decode(errors="replace").strip()
                    if line:
                        self.station.handle_command(line)
                with contextlib.suppress(Exception):
                    await writer.drain()
        finally:
            self._writers.discard(writer)
            with contextlib.suppress(Exception):
                writer.close()

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        # the bound port: the one asked for, or the free one of port=0
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()
