"""gRPC server reflection (v1alpha) — hand-wired.

The reference registers reflection so operators can grpcurl the port
(gomengine/main.go:33 `reflection.Register(s)`). The v1alpha protocol is
implemented directly, so the grpcio-reflection package is not needed: the
two message types the flow needs (ServerReflectionRequest/Response) are
tiny, and raw-bytes generic handlers serve them with manual protobuf wire
framing — no generated code required.

The port of ``gome_tpu/api/reflection.py``: it serves the shared
order.proto descriptor, byte for byte the reference's answers.

Supported requests (what grpcurl/evans use):
  list_services (7)          -> list_services_response (6)
  file_containing_symbol (4) -> file_descriptor_response (4)
  file_by_filename (3)       -> file_descriptor_response (4)
Anything else gets error_response (7) UNIMPLEMENTED.
"""

from __future__ import annotations

import struct

import grpc

from . import order_pb2 as pb
from .service import SERVICE_NAME

REFLECTION_SERVICE = "grpc.reflection.v1alpha.ServerReflection"


# --- minimal protobuf wire helpers ---------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _read_varint(buf: bytes, off: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7


def _field(num: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _parse_fields(buf: bytes) -> list[tuple[int, int, bytes | int]]:
    """-> [(field_number, wire_type, value)] — enough for the request."""
    out = []
    off = 0
    while off < len(buf):
        tag, off = _read_varint(buf, off)
        num, wt = tag >> 3, tag & 7
        if wt == 0:
            val, off = _read_varint(buf, off)
        elif wt == 2:
            ln, off = _read_varint(buf, off)
            val = buf[off : off + ln]
            off += ln
        elif wt == 5:
            val = struct.unpack_from("<I", buf, off)[0]
            off += 4
        elif wt == 1:
            val = struct.unpack_from("<Q", buf, off)[0]
            off += 8
        else:
            break
        out.append((num, wt, val))
    return out


# --- the servicer ---------------------------------------------------------


def _file_descriptor_response(original: bytes) -> bytes:
    fdp = pb.DESCRIPTOR.serialized_pb  # the order.proto FileDescriptorProto
    inner = _field(1, fdp)  # repeated bytes file_descriptor_proto = 1
    return _field(2, original) + _field(4, inner)


def _list_services_response(original: bytes) -> bytes:
    # Only services whose descriptors we can actually serve: advertising
    # the reflection service itself would make describe-every-listed-
    # service tools (evans auto-discovery) hit NOT_FOUND on it.
    services = _field(1, _field(1, SERVICE_NAME.encode()))
    return _field(2, original) + _field(6, services)


def _error_response(original: bytes, code: int, msg: str) -> bytes:
    err = (
        _varint((1 << 3) | 0) + _varint(code)  # error_code = 1
        + _field(2, msg.encode())  # error_message = 2
    )
    return _field(2, original) + _field(7, err)


def _handle(request: bytes) -> bytes:
    for num, _wt, val in _parse_fields(request):
        if num == 7:  # list_services
            return _list_services_response(request)
        if num in (3, 4):  # file_by_filename / file_containing_symbol
            want = val.decode() if isinstance(val, bytes) else ""
            known_symbols = (
                SERVICE_NAME,
                f"{SERVICE_NAME}.DoOrder",
                f"{SERVICE_NAME}.DeleteOrder",
                f"{SERVICE_NAME}.SubscribeMatches",
                "gome_tpu.api.OrderRequest",
                "gome_tpu.api.OrderResponse",
                "gome_tpu.api.SubscribeRequest",
                "gome_tpu.api.MatchEvent",
                "gome_tpu.api.OrderSnapshot",
            )
            if num == 3:
                ok = want == pb.DESCRIPTOR.name
            else:
                ok = want in known_symbols or want.startswith("gome_tpu.api")
            if ok:
                return _file_descriptor_response(request)
            return _error_response(request, 5, f"not found: {want}")  # NOT_FOUND
    return _error_response(request, 12, "unsupported reflection request")


def add_reflection_servicer(server: grpc.Server) -> None:
    """Register ServerReflection (main.go:33's reflection.Register parity)."""

    def server_reflection_info(request_iterator, context):
        for request in request_iterator:
            yield _handle(request)

    handler = grpc.stream_stream_rpc_method_handler(
        server_reflection_info,
        request_deserializer=None,  # raw bytes in
        response_serializer=None,  # raw bytes out
    )
    server.add_generic_rpc_handlers(
        (
            grpc.method_handlers_generic_handler(
                REFLECTION_SERVICE, {"ServerReflectionInfo": handler}
            ),
        )
    )
