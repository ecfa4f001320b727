"""Linux TUN devices for the IP edges (UE GW and SPGW SGi).

Reference behavior: `srsue/src/stack/upper/gw.cc:29-35` (UE TUN, IP<->PDCP
loop) and `srsepc/src/spgw/spgw.cc` (SGi TUN).  Requires CAP_NET_ADMIN;
callers fall back to the in-memory GW when unavailable.
"""

from __future__ import annotations

import fcntl
import os
import struct
import subprocess

TUNSETIFF = 0x400454CA
IFF_TUN = 0x0001
IFF_NO_PI = 0x1000


def available() -> bool:
    return os.path.exists("/dev/net/tun") and os.geteuid() == 0


class TunDevice:
    def __init__(self, name: str, ip_cidr: str = None,
                 ip6_cidr: str = None):
        self.fd = os.open("/dev/net/tun", os.O_RDWR)
        ifr = struct.pack("16sH", name.encode()[:15], IFF_TUN | IFF_NO_PI)
        fcntl.ioctl(self.fd, TUNSETIFF, ifr)
        self.name = name
        if ip_cidr:
            subprocess.run(["ip", "addr", "add", ip_cidr, "dev", name], check=True)
        if ip6_cidr:
            # dual-stack (gw.cc IPv6 path): add the composed global address
            subprocess.run(["ip", "-6", "addr", "add", ip6_cidr,
                            "dev", name], check=True)
        subprocess.run(["ip", "link", "set", name, "up"], check=True)
        os.set_blocking(self.fd, False)

    def read(self, max_pkts: int = 32):
        """Drain up to max_pkts IP packets (non-blocking)."""
        out = []
        for _ in range(max_pkts):
            try:
                pkt = os.read(self.fd, 65535)
            except BlockingIOError:
                break
            if pkt:
                out.append(pkt)
        return out

    def write(self, ip_pkt: bytes):
        os.write(self.fd, ip_pkt)

    def close(self):
        os.close(self.fd)


def attach_ue_gw(ue_stack, tun: TunDevice):
    """Pump between a UE stack's GW queues and a TUN device each TTI."""
    orig_deliver = ue_stack._gw_deliver

    def deliver(ip_pkt):
        orig_deliver(ip_pkt)
        tun.write(ip_pkt)

    ue_stack._gw_deliver = deliver
    # DRB pdcp entity may already exist
    for lcid, ent in getattr(ue_stack, "pdcp", {}).items():
        if not ent.is_srb:
            ent.deliver = deliver

    def pump():
        for pkt in tun.read():
            ue_stack.gw_send(pkt)

    return pump


def attach_sgi(spgw, tun: TunDevice):
    """Pump the SPGW SGi side: TUN -> handle_sgi_pdu; sgi_out -> TUN."""

    def pump():
        for pkt in tun.read():
            spgw.handle_sgi_pdu(pkt)
        while spgw.sgi_out:
            tun.write(spgw.sgi_out.pop(0))

    return pump
