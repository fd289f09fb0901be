"""Minimal RFC-6455 WebSocket server over asyncio (stdlib only).

The reference uses axum/tokio (crates/whisper-tensor-server/src/main.rs);
this environment has no websocket package, so the handshake + framing
layer is implemented directly. Text frames only (the protocol is JSON).

The port's copy of whisper_tensor_tpu/server/ws.py, unchanged
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import struct
from typing import Awaitable, Callable, Optional

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class WebSocketConnection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.open = True

    async def send_text(self, text: str) -> None:
        if not self.open:
            return
        payload = text.encode("utf-8")
        header = bytearray([0x81])  # FIN + text opcode
        n = len(payload)
        if n < 126:
            header.append(n)
        elif n < (1 << 16):
            header.append(126)
            header += struct.pack(">H", n)
        else:
            header.append(127)
            header += struct.pack(">Q", n)
        self.writer.write(bytes(header) + payload)
        await self.writer.drain()

    async def recv(self) -> Optional[str]:
        """Next text message (handles fragmentation, ping/pong, close).
        Returns None when the connection closes."""
        buffer = b""
        while True:
            head = await self._read_exact(2)
            if head is None:
                return None
            fin = bool(head[0] & 0x80)
            opcode = head[0] & 0x0F
            masked = bool(head[1] & 0x80)
            length = head[1] & 0x7F
            if length == 126:
                ext = await self._read_exact(2)
                if ext is None:
                    return None
                length = struct.unpack(">H", ext)[0]
            elif length == 127:
                ext = await self._read_exact(8)
                if ext is None:
                    return None
                length = struct.unpack(">Q", ext)[0]
            mask = b""
            if masked:
                mask = await self._read_exact(4)
                if mask is None:
                    return None
            data = await self._read_exact(length) if length else b""
            if data is None:
                return None
            if masked:
                data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
            if opcode == 0x8:  # close
                await self._send_control(0x8, b"")
                self.open = False
                return None
            if opcode == 0x9:  # ping
                await self._send_control(0xA, data)
                continue
            if opcode == 0xA:  # pong
                continue
            buffer += data
            if fin:
                return buffer.decode("utf-8", errors="replace")

    async def _send_control(self, opcode: int, data: bytes) -> None:
        self.writer.write(bytes([0x80 | opcode, len(data)]) + data)
        await self.writer.drain()

    async def _read_exact(self, n: int):
        try:
            return await self.reader.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError):
            self.open = False
            return None

    def close(self) -> None:
        self.open = False
        try:
            self.writer.close()
        except Exception:
            pass


async def serve_websocket(handler: Callable[[WebSocketConnection], Awaitable[None]],
                          host: str = "127.0.0.1", port: int = 3000):
    """Accept HTTP connections, upgrade to WebSocket, invoke handler."""

    async def on_conn(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, ConnectionError):
            writer.close()
            return
        headers = {}
        for line in request.decode("latin1").split("\r\n")[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        key = headers.get("sec-websocket-key")
        if key is None or "websocket" not in headers.get("upgrade", "").lower():
            # plain HTTP: serve the web UI
            import os

            ui = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "webui.html")
            try:
                with open(ui, "rb") as f:
                    body = f.read()
                ctype = b"text/html; charset=utf-8"
            except OSError:
                body = b"whisper-tensor-tpu server"
                ctype = b"text/plain"
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: " + ctype +
                         b"\r\nContent-Length: " + str(len(body)).encode() +
                         b"\r\n\r\n" + body)
            await writer.drain()
            writer.close()
            return
        accept = base64.b64encode(hashlib.sha1(
            (key + _WS_GUID).encode()).digest()).decode()
        writer.write((
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode("latin1"))
        await writer.drain()
        conn = WebSocketConnection(reader, writer)
        try:
            await handler(conn)
        finally:
            conn.close()

    return await asyncio.start_server(on_conn, host, port)
