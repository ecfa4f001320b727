"""The port's copies of the host-only layers: the L2/L3 stack, the EPC, the
message bus and the PHY adapter, the host runtime, the utilities, the C++
bus and hub sources and the multi-process apps, and their helpers; and the
port's layout: every file of the JAX package has its twin.

They are byte-identical copies of the JAX package's files (their relative
imports land on the port's own modules), except:
- `stack/security.py`, whose AES lines call the port's plain-Python
  `stack/aes.py` instead of the `cryptography` package: the card's machine
  has no such package.  `aes.py` is held byte for byte against the
  reference's OpenSSL-backed functions, and the port's stack, EPC and
  waveform network import with `cryptography` blocked;
- `utils/wire.py`, whose restricted unpickler admits the port's modules
  (and no module of the JAX package) on its one module-check line;
- `apps/{enb_app,epc_app,hub_app,rpc,ue_app}.py`, whose usage strings name
  `srslte_emane_tpu_torch.apps`.
"""

import difflib
import filecmp
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import srslte_emane_tpu
import srslte_emane_tpu_torch
from srslte_emane_tpu.stack import security as j_sec
from srslte_emane_tpu_torch.stack import aes as p_aes, security as p_sec

REF = pathlib.Path(srslte_emane_tpu.__file__).parent
PORT = pathlib.Path(srslte_emane_tpu_torch.__file__).parent
COPIED = sorted(
    [str(f.relative_to(REF)) for d in ("stack", "stack/asn1", "epc")
     for f in (REF / d).iterdir() if f.suffix in (".py", ".npz")
     and f.name != "security.py"]
    + ["runtime/otamsg.py", "runtime/otabus.py", "runtime/phy_adapter.py",
       "utils/timers.py", "utils/pcap.py"]
    + [f"runtime/{m}.py" for m in ("checkpoint", "distrib", "native_bus", "syssim", "ttiloop")]
    + [f"utils/{m}.py" for m in ("config", "crash_handler", "iq_io", "logging_util", "metrics",
                                 "tun")]
    + ["native/emanelte_bus.cpp", "native/ota_hub.cpp", "apps/__init__.py",
       "parallel/__init__.py"])
# the apps copied with their usage strings naming the port
APPS = ["enb_app", "epc_app", "hub_app", "rpc", "ue_app"]
# the files of the JAX package whose twin has another name: the Pallas MAP
# kernels, ported as hand-written CUDA kernels
RENAMED = {"ops/fec/turbodecoder_pallas2.py": "csrc/turbo_map.cu",
           "ops/fec/turbodecoder_pallas.py": "csrc/turbo_map_v1.cu"}
# the JAX repository's measuring entry points (relative to its root) and
# their twins in the port's package
ENTRY_POINTS = {"bench.py": "bench.py",
                **{f"scripts/{m}.py": f"scripts/{m}.py"
                   for m in ("snr_sweep", "bench_extra", "bench_waveform_tpu",
                             "bench_waveblock_dyn", "bench_waveform_paced", "profile_stages",
                             "wavenet_smoke", "profile_turbo", "profile_mimo",
                             "profile_dynblock")}}
# reference security.py lines (1-based) that the port changes: the docstring's
# AES line, the cryptography imports, and the bodies of _aes_ecb, eea2's CTR
# and eia2's CMAC
SECURITY_LINES = {9, 18, 19, 20, 27, 28, 42, 43, 71, 72, 73}


def test_copy_list_is_complete():
    assert len(COPIED) == 54
    names = {pathlib.Path(c).name for c in COPIED}
    assert {"enb_stack.py", "ue_stack.py", "rrc36331.py", "mme.py", "snow3g_tables.npz",
            "zuc_tables.npz", "distrib.py", "ttiloop.py", "metrics.py",
            "ota_hub.cpp"} <= names


def test_every_reference_file_has_a_twin():
    """Each .py / .cpp file of the JAX package has its twin at the same
    relative path in the port, but for the two Pallas kernel files."""
    ref = sorted(str(f.relative_to(REF)) for f in REF.rglob("*")
                 if f.suffix in (".py", ".cpp") and "__pycache__" not in f.parts)
    assert len(ref) > 100
    missing = [r for r in ref if not (PORT / RENAMED.get(r, r)).is_file()]
    assert not missing, missing
    assert set(RENAMED) <= set(ref)


@pytest.mark.parametrize("ref", sorted(ENTRY_POINTS))
def test_every_entry_point_has_a_twin(ref):
    """bench.py and the scripts that measure the JAX package each have a
    twin under srslte_emane_tpu_torch/, run as `python -m`."""
    assert (REF.parent / ref).is_file()
    twin = PORT / ENTRY_POINTS[ref]
    assert twin.is_file(), twin
    assert "def main(argv=None)" in twin.read_text()


def test_wire_differs_only_on_its_module_check():
    ref = (REF / "utils/wire.py").read_text().splitlines()
    port = (PORT / "utils/wire.py").read_text().splitlines()
    assert len(ref) == len(port)
    changed = [i + 1 for i, (a, b) in enumerate(zip(ref, port)) if a != b]
    assert changed == [42], changed
    assert port[41].strip() == ('if module == "srslte_emane_tpu_torch" or '
                                'module.startswith("srslte_emane_tpu_torch."):')


@pytest.mark.parametrize("name", APPS)
def test_app_is_a_copy_naming_the_port(name):
    ref = (REF / f"apps/{name}.py").read_text()
    port = (PORT / f"apps/{name}.py").read_text()
    assert port == ref.replace("srslte_emane_tpu.apps.", "srslte_emane_tpu_torch.apps.")
    assert "srslte_emane_tpu." not in port


@pytest.mark.parametrize("rel", COPIED)
def test_file_is_a_byte_identical_copy(rel):
    assert filecmp.cmp(PORT / rel, REF / rel, shallow=False), rel


def test_security_differs_only_on_its_aes_lines():
    ref = (REF / "stack/security.py").read_text().splitlines()
    port = (PORT / "stack/security.py").read_text().splitlines()
    changed = set()
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(None, ref, port, autojunk=False).get_opcodes():
        if tag != "equal":
            changed.update(range(i1 + 1, i2 + 1))
            assert i2 > i1, "a line inserted outside the AES lines"
    assert changed == SECURITY_LINES, sorted(changed)
    text = "\n".join(port)
    assert "cryptography" not in text and "from . import aes" in text


def _rng_cases(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield rng


def test_aes_block_fips197_and_openssl():
    # FIPS-197 Appendix C.1
    assert p_aes.encrypt_block(bytes(range(16)), bytes.fromhex(
        "00112233445566778899aabbccddeeff")).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    for rng in _rng_cases(64, 1):
        key, block = rng.bytes(16), rng.bytes(16)
        assert p_sec._aes_ecb(key, block) == j_sec._aes_ecb(key, block)


@pytest.mark.parametrize("which", ["eea2", "eia2"])
def test_eea2_eia2_equal_openssl(which):
    rng = np.random.default_rng(2 if which == "eea2" else 3)
    for n in range(0, 301):
        key, data = rng.bytes(16), rng.bytes(n)
        count = int(rng.integers(0, 2 ** 32))
        bearer, direction = int(rng.integers(0, 32)), int(rng.integers(0, 2))
        args = (key, count, bearer, direction, data)
        assert getattr(p_sec, which)(*args) == getattr(j_sec, which)(*args), n


def test_ctr_counter_wraps_like_openssl():
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    rng = np.random.default_rng(4)
    key, data = rng.bytes(16), rng.bytes(80)
    iv = b"\xff" * 15 + b"\xfe"  # the counter passes 2^128 inside the message
    enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    assert p_aes.ctr(key, iv, data) == enc.update(data) + enc.finalize()


def test_milenage_equal_openssl():
    for rng in _rng_cases(16, 5):
        k, op, rand = rng.bytes(16), rng.bytes(16), rng.bytes(16)
        sqn, amf = rng.bytes(6), rng.bytes(2)
        opc = p_sec.milenage_opc(k, op)
        assert opc == j_sec.milenage_opc(k, op)
        for fn, args in (("milenage_f1", (k, opc, rand, sqn, amf)),
                         ("milenage_f1_star", (k, opc, rand, sqn, amf)),
                         ("milenage_f2345", (k, opc, rand)),
                         ("milenage_f5_star", (k, opc, rand))):
            assert getattr(p_sec, fn)(*args) == getattr(j_sec, fn)(*args), fn


def test_milenage_35208_test_set_1():
    """TS 35.208 §4.3 test set 1."""
    k = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
    rand = bytes.fromhex("23553cbe9637a89d218ae64dae47bf35")
    sqn, amf = bytes.fromhex("ff9bb4d0b607"), bytes.fromhex("b9b9")
    opc = p_sec.milenage_opc(k, bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318"))
    assert opc.hex() == "cd63cb71954a9f4e48a5994e37a02baf"
    assert p_sec.milenage_f1(k, opc, rand, sqn, amf).hex() == "4a9ffac354dfafb3"
    res, ck, ik, ak = p_sec.milenage_f2345(k, opc, rand)
    assert (res.hex(), ck.hex(), ik.hex(), ak.hex()) == (
        "a54211d5e3ba50bf", "b40ba9a3c58b2a05bbf0d987b21bf8cb",
        "f769bcd751044604127672711c6d3441", "aa689c648370")


def test_port_host_layers_import_without_cryptography():
    """The stack, the EPC, the waveform network and the apps import (and run
    the AKA's Milenage) with every `cryptography` import refused."""
    code = """
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "cryptography" or name.startswith("cryptography."):
            raise ImportError("cryptography is blocked")
        return None

sys.meta_path.insert(0, Block())
for m in [m for m in sys.modules if m.startswith("cryptography")]:
    del sys.modules[m]
import srslte_emane_tpu_torch.stack.enb_stack, srslte_emane_tpu_torch.stack.ue_stack
import srslte_emane_tpu_torch.epc.hss, srslte_emane_tpu_torch.epc.mme
import srslte_emane_tpu_torch.epc.spgw, srslte_emane_tpu_torch.epc.s1ap_wire
import srslte_emane_tpu_torch.runtime.wavenet, srslte_emane_tpu_torch.runtime.otabus
import srslte_emane_tpu_torch.apps.netsim, srslte_emane_tpu_torch.apps.enb_app
import srslte_emane_tpu_torch.apps.ue_app, srslte_emane_tpu_torch.apps.epc_app
import srslte_emane_tpu_torch.apps.netscan_app, srslte_emane_tpu_torch.parallel.dryrun
import srslte_emane_tpu_torch.runtime.syssim, srslte_emane_tpu_torch.utils.radio
from srslte_emane_tpu_torch.stack import security
opc = security.milenage_opc(bytes(range(16)), bytes(16))
assert len(security.milenage_f2345(bytes(range(16)), opc, bytes(16))[0]) == 8
assert not any(m.startswith(("cryptography", "jax", "srslte_emane_tpu.")) for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PORT.parent, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
