"""NAS 5GS (TS 24.501): registration + PDU session procedures.

Reference: openair3/NAS (83k LoC of generated/handwritten C for 4G+5G).
NAS is a byte-oriented TLV protocol — encoded here directly with
dataclass codecs.  Covers the message set a UE needs to register and
establish a PDU session against a core (the 5g_rfsimulator CI flow):
Registration Request/Accept/Complete, Authentication Request/Response,
Security Mode Command/Complete, PDU Session Establishment Request/
Accept, plus the 5G-GUTI / SUCI identity encodings.

A copy of openairinterface5g_tpu/l3/nas.py (pure Python; the port imports
nothing of the JAX package); tests/test_torch_l3.py holds the two
codes equal.
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac
import struct

EPD_MM = 0x7E      # 5GS mobility management
EPD_SM = 0x2E      # 5GS session management

MSG_REGISTRATION_REQUEST = 0x41
MSG_REGISTRATION_ACCEPT = 0x42
MSG_REGISTRATION_COMPLETE = 0x43
MSG_AUTH_REQUEST = 0x56
MSG_AUTH_RESPONSE = 0x57
MSG_SECURITY_MODE_COMMAND = 0x5D
MSG_SECURITY_MODE_COMPLETE = 0x5E
MSG_UL_NAS_TRANSPORT = 0x67
MSG_DL_NAS_TRANSPORT = 0x68
MSG_DEREGISTRATION_REQUEST = 0x45   # UE originating
MSG_DEREGISTRATION_ACCEPT = 0x46
MSG_SERVICE_REQUEST = 0x4C
MSG_SERVICE_ACCEPT = 0x4E
MSG_SERVICE_REJECT = 0x4D
MSG_IDENTITY_REQUEST = 0x5B
MSG_IDENTITY_RESPONSE = 0x5C
MSG_CONFIG_UPDATE_COMMAND = 0x54
MSG_CONFIG_UPDATE_COMPLETE = 0x55
MSG_5GMM_STATUS = 0x64
MSG_PDU_SESSION_ESTABLISH_REQ = 0xC1
MSG_PDU_SESSION_ESTABLISH_ACCEPT = 0xC2
MSG_PDU_SESSION_MODIFY_REQ = 0xC9
MSG_PDU_SESSION_MODIFY_CMD = 0xCB
MSG_PDU_SESSION_MODIFY_COMPLETE = 0xCC
MSG_PDU_SESSION_RELEASE_REQ = 0xD1
MSG_PDU_SESSION_RELEASE_CMD = 0xD3
MSG_PDU_SESSION_RELEASE_COMPLETE = 0xD4


@dataclasses.dataclass
class NasMessage:
    epd: int
    msg_type: int
    ies: dict
    session_id: int = 0     # 5GSM only
    pti: int = 0


def encode_mm(msg_type: int, ies: dict) -> bytes:
    """Plain (unciphered) 5GMM message: EPD, security header 0, type, IEs."""
    out = bytes([EPD_MM, 0x00, msg_type])
    for tag, val in ies.items():
        out += bytes([tag, len(val)]) + val
    return out


def encode_sm(msg_type: int, session_id: int, pti: int, ies: dict) -> bytes:
    out = bytes([EPD_SM, session_id, pti, msg_type])
    for tag, val in ies.items():
        out += bytes([tag, len(val)]) + val
    return out


def decode(pdu: bytes) -> NasMessage:
    epd = pdu[0]
    sid = pti = 0
    if epd == EPD_MM:
        msg_type, body = pdu[2], pdu[3:]
    else:
        sid, pti = pdu[1], pdu[2]
        msg_type, body = pdu[3], pdu[4:]
    ies, i = {}, 0
    while i + 2 <= len(body):
        tag, ln = body[i], body[i + 1]
        ies[tag] = body[i + 2: i + 2 + ln]
        i += 2 + ln
    return NasMessage(epd=epd, msg_type=msg_type, ies=ies,
                      session_id=sid, pti=pti)


# IE tags (subset)
IE_5GS_MOBILE_ID = 0x77
IE_UE_SECURITY_CAP = 0x2E
IE_AUTH_PARAM_RAND = 0x21
IE_AUTH_RESPONSE_PARAM = 0x2D
IE_5G_GUTI = 0x77
IE_PDU_ADDRESS = 0x29
IE_NAS_CONTAINER = 0x71


def suci(mcc: int, mnc: int, msin: str) -> bytes:
    """SUCI (null protection scheme) identity IE value."""
    plmn = struct.pack(">HB", mcc, mnc)
    return bytes([0x01]) + plmn + bytes.fromhex(msin.zfill(10 + len(msin) % 2))


def registration_request(mcc=1, mnc=1, msin="0000000001") -> bytes:
    return encode_mm(MSG_REGISTRATION_REQUEST, {
        IE_5GS_MOBILE_ID: suci(mcc, mnc, msin),
        IE_UE_SECURITY_CAP: bytes([0xE0, 0xE0]),    # EA0-2 / IA0-2
    })


def authentication_request(rand: bytes) -> bytes:
    assert len(rand) == 16
    return encode_mm(MSG_AUTH_REQUEST, {IE_AUTH_PARAM_RAND: rand})


def authentication_response(rand: bytes, key: bytes) -> bytes:
    """RES* computed as an HMAC over RAND (stands in for 5G-AKA milenage;
    the reference's USIM algorithms live in openair3/NAS/COMMON/milenage)."""
    res = hmac.new(key, rand, hashlib.sha256).digest()[:16]
    return encode_mm(MSG_AUTH_RESPONSE, {IE_AUTH_RESPONSE_PARAM: res})


def security_mode_command() -> bytes:
    return encode_mm(MSG_SECURITY_MODE_COMMAND, {
        IE_UE_SECURITY_CAP: bytes([0xE0, 0xE0])})


def security_mode_complete() -> bytes:
    return encode_mm(MSG_SECURITY_MODE_COMPLETE, {})


def registration_accept(guti: bytes = b"\x00" * 11) -> bytes:
    return encode_mm(MSG_REGISTRATION_ACCEPT, {IE_5G_GUTI: guti})


def pdu_session_establishment_request(session_id=1, pti=1) -> bytes:
    return encode_sm(MSG_PDU_SESSION_ESTABLISH_REQ, session_id, pti, {})


def pdu_session_establishment_accept(session_id=1, pti=1,
                                     ue_ip="10.0.0.2") -> bytes:
    ip = bytes(int(x) for x in ue_ip.split("."))
    return encode_sm(MSG_PDU_SESSION_ESTABLISH_ACCEPT, session_id, pti, {
        IE_PDU_ADDRESS: bytes([0x01]) + ip})


IE_QOS_RULES = 0x7A
IE_TMSI = 0x50


def service_request(tmsi: bytes = b"\x00" * 4) -> bytes:
    """24.501 §8.2.16: idle-to-connected resume."""
    return encode_mm(MSG_SERVICE_REQUEST, {IE_TMSI: tmsi})


def service_accept() -> bytes:
    return encode_mm(MSG_SERVICE_ACCEPT, {})


def deregistration_request(tmsi: bytes = b"\x00" * 4) -> bytes:
    """24.501 §8.2.12 (UE originating, switch-off=0)."""
    return encode_mm(MSG_DEREGISTRATION_REQUEST, {IE_TMSI: tmsi})


def deregistration_accept() -> bytes:
    return encode_mm(MSG_DEREGISTRATION_ACCEPT, {})


def identity_request() -> bytes:
    return encode_mm(MSG_IDENTITY_REQUEST, {})


def identity_response(mcc=1, mnc=1, msin="0000000001") -> bytes:
    return encode_mm(MSG_IDENTITY_RESPONSE,
                     {IE_5GS_MOBILE_ID: suci(mcc, mnc, msin)})


def configuration_update_command(guti: bytes = b"\x01" * 11) -> bytes:
    """24.501 §8.2.19: network-initiated GUTI reallocation."""
    return encode_mm(MSG_CONFIG_UPDATE_COMMAND, {IE_5G_GUTI: guti})


def configuration_update_complete() -> bytes:
    return encode_mm(MSG_CONFIG_UPDATE_COMPLETE, {})


def pdu_session_release_request(session_id=1, pti=2) -> bytes:
    return encode_sm(MSG_PDU_SESSION_RELEASE_REQ, session_id, pti, {})


def pdu_session_release_command(session_id=1, pti=2) -> bytes:
    return encode_sm(MSG_PDU_SESSION_RELEASE_CMD, session_id, pti, {})


def pdu_session_release_complete(session_id=1, pti=2) -> bytes:
    return encode_sm(MSG_PDU_SESSION_RELEASE_COMPLETE, session_id, pti, {})


def pdu_session_modification_request(session_id=1, pti=3,
                                     qos: bytes = b"\x01") -> bytes:
    return encode_sm(MSG_PDU_SESSION_MODIFY_REQ, session_id, pti,
                     {IE_QOS_RULES: qos})


def pdu_session_modification_command(session_id=1, pti=3,
                                     qos: bytes = b"\x01") -> bytes:
    return encode_sm(MSG_PDU_SESSION_MODIFY_CMD, session_id, pti,
                     {IE_QOS_RULES: qos})


def pdu_session_modification_complete(session_id=1, pti=3) -> bytes:
    return encode_sm(MSG_PDU_SESSION_MODIFY_COMPLETE, session_id, pti, {})


# --------------------------------------------------------------------------
# minimal AMF-side and UE-side procedure drivers (for closed-loop tests)
# --------------------------------------------------------------------------


class AmfStub:
    """Answers the registration + session flow like a tiny core network
    (the role the CI's containerized 5GC plays for the reference)."""

    def __init__(self, key: bytes = b"\x00" * 16):
        self.key = key
        self.rand = bytes(range(16))
        self.state = "IDLE"
        self.ue_ip = "10.0.0.2"

    def handle(self, pdu: bytes) -> list[bytes]:
        m = decode(pdu)
        if m.msg_type == MSG_REGISTRATION_REQUEST:
            self.state = "AUTH"
            return [authentication_request(self.rand)]
        if m.msg_type == MSG_AUTH_RESPONSE:
            expected = hmac.new(self.key, self.rand,
                                hashlib.sha256).digest()[:16]
            if m.ies.get(IE_AUTH_RESPONSE_PARAM) != expected:
                return []
            self.state = "SMC"
            return [security_mode_command()]
        if m.msg_type == MSG_SECURITY_MODE_COMPLETE:
            self.state = "REGISTERED"
            return [registration_accept()]
        if m.epd == EPD_SM and m.msg_type == MSG_PDU_SESSION_ESTABLISH_REQ:
            self.state = "SESSION"
            return [pdu_session_establishment_accept(ue_ip=self.ue_ip)]
        if m.msg_type == MSG_SERVICE_REQUEST and m.epd == EPD_MM:
            return [service_accept()]
        if m.msg_type == MSG_DEREGISTRATION_REQUEST and m.epd == EPD_MM:
            self.state = "DEREGISTERED"
            return [deregistration_accept()]
        if m.msg_type == MSG_IDENTITY_RESPONSE and m.epd == EPD_MM:
            return []
        if m.msg_type == MSG_CONFIG_UPDATE_COMPLETE and m.epd == EPD_MM:
            return []
        if m.epd == EPD_SM and m.msg_type == MSG_PDU_SESSION_RELEASE_REQ:
            return [pdu_session_release_command(m.session_id, m.pti)]
        if m.epd == EPD_SM and m.msg_type == MSG_PDU_SESSION_RELEASE_COMPLETE:
            self.state = "REGISTERED"
            return []
        if m.epd == EPD_SM and m.msg_type == MSG_PDU_SESSION_MODIFY_REQ:
            return [pdu_session_modification_command(
                m.session_id, m.pti, m.ies.get(IE_QOS_RULES, b"\x01"))]
        if m.epd == EPD_SM and m.msg_type == MSG_PDU_SESSION_MODIFY_COMPLETE:
            return []
        return []


class UeNas:
    """UE NAS state machine for the same flow."""

    def __init__(self, key: bytes = b"\x00" * 16):
        self.key = key
        self.state = "IDLE"
        self.ip: str | None = None
        self.guti: bytes | None = None
        self.qos: bytes | None = None

    def start(self) -> bytes:
        self.state = "REGISTERING"
        return registration_request()

    def handle(self, pdu: bytes) -> list[bytes]:
        m = decode(pdu)
        if m.msg_type == MSG_AUTH_REQUEST:
            return [authentication_response(m.ies[IE_AUTH_PARAM_RAND], self.key)]
        if m.msg_type == MSG_SECURITY_MODE_COMMAND:
            return [security_mode_complete()]
        if m.msg_type == MSG_REGISTRATION_ACCEPT:
            self.state = "REGISTERED"
            return [pdu_session_establishment_request()]
        if m.epd == EPD_SM and m.msg_type == MSG_PDU_SESSION_ESTABLISH_ACCEPT:
            self.state = "SESSION"
            addr = m.ies.get(IE_PDU_ADDRESS, b"")
            if len(addr) == 5:
                self.ip = ".".join(str(b) for b in addr[1:])
            return []
        if m.msg_type == MSG_IDENTITY_REQUEST and m.epd == EPD_MM:
            return [identity_response()]
        if m.msg_type == MSG_CONFIG_UPDATE_COMMAND and m.epd == EPD_MM:
            self.guti = m.ies.get(IE_5G_GUTI)
            return [configuration_update_complete()]
        if m.msg_type == MSG_SERVICE_ACCEPT and m.epd == EPD_MM:
            self.state = "SESSION" if self.ip else "REGISTERED"
            return []
        if m.msg_type == MSG_DEREGISTRATION_ACCEPT and m.epd == EPD_MM:
            self.state = "DEREGISTERED"
            return []
        if m.epd == EPD_SM and m.msg_type == MSG_PDU_SESSION_RELEASE_CMD:
            self.ip = None
            self.state = "REGISTERED"
            return [pdu_session_release_complete(m.session_id, m.pti)]
        if m.epd == EPD_SM and m.msg_type == MSG_PDU_SESSION_MODIFY_CMD:
            self.qos = m.ies.get(IE_QOS_RULES)
            return [pdu_session_modification_complete(m.session_id, m.pti)]
        return []

    # --- idle-mode / teardown procedures (24.501 §5.6, §5.5.2) ---

    def request_service(self) -> bytes:
        self.state = "SERVICE_REQ"
        return service_request()

    def request_deregistration(self) -> bytes:
        self.state = "DEREGISTERING"
        return deregistration_request()

    def request_session_release(self, session_id=1) -> bytes:
        return pdu_session_release_request(session_id)

    def request_session_modification(self, session_id=1,
                                     qos: bytes = b"\x05") -> bytes:
        return pdu_session_modification_request(session_id, qos=qos)
