"""OTA message schema for the message-level emulation mode.

Reference behavior: the protobuf messages exchanged through libemanelte
(SURVEY.md §8; built by `srsenb/src/phy/phy_adapter.cc:795-975` and
`srsue/src/phy/phy_adapter.cc:1525-1874`): one ENB_DL_Message +
TxControlMessage per eNB per TTI, one UE_UL_Message + TxControlMessage per UE
per TTI.  The reference's UL grant/uci fields are raw C-struct blobs
(SURVEY.md §8 note); here every field is explicit schema.

These are plain dataclasses; the wire format (for multi-host DCN transport)
is msgpack-style dict serialization — see otabus.serialize.
"""

from __future__ import annotations

import dataclasses
import enum
import typing


class Chan(enum.IntEnum):
    """Channel types adjudicated by the SINR tester (CHAN_* enums)."""
    PBCH = 0
    PCFICH = 1
    PDCCH = 2
    PDSCH = 3
    PHICH = 4
    PMCH = 5
    PRACH = 6
    PUCCH = 7
    PUSCH = 8


class Mod(enum.IntEnum):
    BPSK = 1
    QPSK = 2
    QAM16 = 4
    QAM64 = 6
    QAM256 = 8


@dataclasses.dataclass
class ChannelMessage:
    """Per-channel control info driving the per-RB SINR model
    (initDownlinkChannelMessage, phy_adapter.cc:821-855)."""
    channel_type: Chan
    modulation: Mod
    number_of_bits: int
    rnti: int = 0
    # PRB indices used in each slot (the reference sends center frequencies;
    # indices are sufficient and exact for the emulation kernel)
    prb_slot0: tuple = ()
    prb_slot1: tuple = ()


@dataclasses.dataclass
class TxControl:
    tti_tx: int
    phy_cell_id: int
    is_downlink: bool
    tx_seqnum: int = 0
    reference_signal_power_mw: float = 1.0
    num_resource_blocks: int = 6
    cfi: int = 1
    channels: typing.List[ChannelMessage] = dataclasses.field(default_factory=list)
    # carrier index (EARFCN stand-in): emissions on different carriers are
    # independent interference domains (the reference keys its SINR model on
    # center frequency; carrier aggregation SCells live here)
    freq_idx: int = 0


@dataclasses.dataclass
class DciMsg:
    rnti: int
    format: str
    l_level: int
    l_ncce: int
    num_bits: int
    data: bytes  # packed DCI payload bits


@dataclasses.dataclass
class PdschData:
    refid: int
    tb: int
    tbs: int
    data: bytes


@dataclasses.dataclass
class EnbDlMessage:
    """ENB_DL_Message (phy_adapter.cc:806-935)."""
    tti: int
    cfi: int
    phy_cell_id: int
    carrier_idx: int = 0  # 0 = PCell, >=1 = SCell component carriers
    pss_sss: bool = False
    cp_mode: int = 0
    pbch: typing.Optional[dict] = None  # {phich_resources, phich_length, num_prb, num_antennas, mib_data}
    pdcch_dl: typing.List[DciMsg] = dataclasses.field(default_factory=list)
    pdcch_ul: typing.List[DciMsg] = dataclasses.field(default_factory=list)
    pdsch: typing.List[PdschData] = dataclasses.field(default_factory=list)
    phich: typing.List[dict] = dataclasses.field(default_factory=list)  # {rnti, ack}
    pmch: typing.Optional[dict] = None  # {area_id, tbs, rnti, data}


@dataclasses.dataclass
class UeUlMessage:
    """UE_UL_Message (srsue phy_adapter.cc:1530-1874)."""
    tti: int
    crnti: int
    phy_cell_id: int
    prach: typing.Optional[dict] = None  # {preamble_index}
    pucch: typing.List[dict] = dataclasses.field(default_factory=list)
    # {rnti, num_prb, num_pucch, sr, ack[], cqi}
    pusch: typing.List[dict] = dataclasses.field(default_factory=list)
    # {rnti, rb_start, l_prb, mcs, rv, ndi, payload: bytes}


@dataclasses.dataclass
class OtaFrame:
    """One transmitter's emission for one TTI: message + tx control."""
    src: int  # node id (NEM id equivalent)
    msg: typing.Union[EnbDlMessage, UeUlMessage]
    txc: TxControl
