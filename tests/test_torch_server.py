"""The port's TCP command server (``amps_tpu_torch.control.server``):
the operator's Socket PDU on an ephemeral port (``port=0``, read back
after ``start()``), line framing across TCP segments, the EOF flush,
newline-delimited debug lines, and a broadcast that races the event
loop's shutdown, where the port drops the line (ADVICE.md r5 finding 4)
and the JAX package's server raises."""

import asyncio
import contextlib
import threading

import pytest

from amps_tpu.control.server import CommandServer as JServer
from amps_tpu.control.station import BaseStation as JStation
from amps_tpu_torch.control.server import CommandServer
from amps_tpu_torch.control.station import BaseStation


def test_tcp_command_server():
    async def run():
        st = BaseStation()
        srv = CommandServer(st, port=0)
        await srv.start()
        assert srv.port > 0
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        writer.write(b"page 5551234567\n")
        await writer.drain()
        # debug reply reaches the operator socket
        data = await asyncio.wait_for(reader.read(100), timeout=5)
        assert b"paging" in data
        writer.write(b"garbage\n")
        await writer.drain()
        data = await asyncio.wait_for(reader.read(100), timeout=5)
        assert b"invalid command" in data
        writer.close()
        await srv.stop()
        assert len([e for e in st.events if e.kind == "focc_words"]) == 1

    asyncio.run(run())


def test_tcp_command_split_across_segments_and_newline_delimited_debug():
    """A command split across two TCP segments executes as ONE command;
    every debug broadcast is newline-delimited; an unterminated trailing
    command is flushed at EOF."""
    async def run():
        st = BaseStation()
        srv = CommandServer(st, port=0)
        await srv.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        # one command, two segments, split mid-MIN
        writer.write(b"page 55512")
        await writer.drain()
        await asyncio.sleep(0.05)
        writer.write(b"34567\npage 415")
        await writer.drain()
        data = await asyncio.wait_for(reader.read(200), timeout=5)
        assert b"paging" in data and data.endswith(b"\n")
        # the second command is still incomplete: one page executed
        assert len([e for e in st.events if e.kind == "focc_words"]) == 1
        # EOF flushes the trailing unterminated command
        writer.write(b"5559876")
        await writer.drain()
        writer.write_eof()
        await asyncio.sleep(0.2)
        assert len([e for e in st.events if e.kind == "focc_words"]) == 2
        writer.close()
        await srv.stop()

    asyncio.run(run())


@contextlib.contextmanager
def _closing_loop_server(server_cls, station):
    """A server whose event loop has closed while ``is_closed()`` still
    reads False: the window between the check and
    ``call_soon_threadsafe`` in which the loop shuts down."""
    srv = server_cls(station, port=0)
    loop = asyncio.new_event_loop()
    loop.run_until_complete(srv.start())
    loop.run_until_complete(srv.stop())
    loop.close()
    loop.is_closed = lambda: False
    try:
        yield srv
    finally:
        del loop.is_closed


def _broadcast_from_thread(station):
    errors = []

    def body():
        try:
            station._debug("late debug line at shutdown")
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=body)
    t.start()
    t.join(10)
    return errors


@pytest.mark.parametrize("package", ["port", "jax"])
def test_broadcast_racing_loop_shutdown(package):
    """ADVICE.md r5 finding 4: a station event from another thread while
    the server's loop closes.  The port's best-effort broadcast drops the
    line; the JAX package's raises RuntimeError into the caller (here the
    RX thread that dispatched the burst)."""
    st = BaseStation() if package == "port" else JStation()
    server_cls = CommandServer if package == "port" else JServer
    with _closing_loop_server(server_cls, st) as srv:
        errors = _broadcast_from_thread(st)
    if package == "port":
        assert errors == []
    else:
        assert len(errors) == 1 and isinstance(errors[0], RuntimeError)
    assert srv._server is None
    assert st.events[-1].payload == "late debug line at shutdown"
