"""Layered configuration: defaults <- .conf file <- CLI flags.

Reference behavior: boost::program_options + libconfig in the four app mains
(`srsenb/src/main.cc:100-230`) — every config key is also a CLI flag; the
-emane fork adds [runtime] daemonize and the [mhal] section
(srsenb/src/main.cc:160-170).  File format here is INI (configparser), the
same section.key addressing.
"""

from __future__ import annotations

import argparse
import configparser
import dataclasses
import typing


@dataclasses.dataclass
class EnbConfig:
    enb_id: int = 1
    cell_id: int = 1
    n_prb: int = 25
    n_ports: int = 1
    cfi: int = 1
    mcs: int = 9
    tx_power_mw: float = 1.0
    phich_resources: str = "1"
    mhal_statistic_endpoint: str = "0.0.0.0:47100"
    daemonize: bool = False
    pcap_enable: bool = False
    pcap_filename: str = "/tmp/enb_mac.pcap"
    log_level: str = "info"
    metrics_period_ttis: int = 1000
    metrics_csv: str = ""
    # RRC admission control: 0 = unlimited, else RRCConnectionReject
    # once this many RRC_CONNECTED users exist (srsenb rrc max_users)
    max_rrc_users: int = 0
    # SIB3 cell-reselection hysteresis broadcast to idle UEs (dB)
    q_hyst_db: int = 2
    # PLMN broadcast in SIB1 (simplified int riding the MNC digits, 0..99)
    plmn: int = 1
    # eMBMS (enb.conf.example [embms] role): enable starts SIB13 + MCCH
    # broadcasting for the configured area without waiting for M2AP
    embms_enable: bool = False
    embms_area_id: int = 1
    embms_service_id: int = 1


@dataclasses.dataclass
class UeConfig:
    imsi: str = "001010000000001"
    key_hex: str = "000102030405060708090a0b0c0d0e0f"
    op_hex: str = "00000000000000000000000000000000"
    preamble: int = 7
    tx_power_mw: float = 1.0
    # home PLMN for cell suitability (36.304; simplified int, 0..99)
    hplmn: int = 1
    # autostart MBMS reception (ue.conf.example mbms_service_id/port):
    # -1 = disabled
    mbms_service_id: int = -1
    mbms_service_port: int = 4321
    pcap_enable: bool = False
    pcap_filename: str = "/tmp/ue_mac.pcap"
    log_level: str = "info"


@dataclasses.dataclass
class EpcConfig:
    mme_code: int = 1
    ip_pool: str = "172.16.0."
    user_db: str = ""


_SECTION = {
    "enb": {"enb_id", "cell_id", "n_prb", "n_ports", "cfi", "mcs", "plmn"},
    "embms": {"embms_enable", "embms_area_id", "embms_service_id"},
    "rf": {"tx_power_mw"},
    "expert": {"phich_resources", "metrics_period_ttis", "metrics_csv"},
    "mhal": {"mhal_statistic_endpoint"},
    "runtime": {"daemonize"},
    "pcap": {"pcap_enable", "pcap_filename"},
    "log": {"log_level"},
    "usim": {"imsi", "key_hex", "op_hex", "hplmn"},
    "rrc": {"preamble", "mbms_service_id", "mbms_service_port"},
    "mme": {"mme_code"},
    "spgw": {"ip_pool"},
    "hss": {"user_db"},
}


def _coerce(cur, raw: str):
    if isinstance(cur, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(cur, int):
        return int(raw, 0)
    if isinstance(cur, float):
        return float(raw)
    return raw


def load(cls, conf_path: str = None, cli_args: typing.Sequence[str] = ()):
    """Build a config dataclass: defaults, then conf file sections, then
    --section.key=value CLI overrides."""
    cfg = cls()
    if conf_path:
        cp = configparser.ConfigParser()
        cp.read(conf_path)
        for section in cp.sections():
            for key, raw in cp.items(section):
                if hasattr(cfg, key):
                    setattr(cfg, key, _coerce(getattr(cfg, key), raw))
    parser = argparse.ArgumentParser(add_help=False)
    for f in dataclasses.fields(cls):
        parser.add_argument(f"--{f.name}", type=str, default=None)
    ns, _ = parser.parse_known_args(list(cli_args))
    for f in dataclasses.fields(cls):
        raw = getattr(ns, f.name)
        if raw is not None:
            setattr(cfg, f.name, _coerce(getattr(cfg, f.name), raw))
    return cfg
