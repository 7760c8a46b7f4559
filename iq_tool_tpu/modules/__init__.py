"""Module registry (src/module_manager.c:44-172 analog).

Inputs and outputs register by name; the CLI assembles options from every
registered module so --help shows exactly what is available
(module_manager.c:224-258).
"""

from __future__ import annotations

from iq_tool_tpu.modules.base import InputModule, OutputModule  # noqa: F401
from iq_tool_tpu.modules.input_rawfile import RawFileInput
from iq_tool_tpu.modules.input_tone import ToneInput
from iq_tool_tpu.modules.input_wav import WavInput
from iq_tool_tpu.modules.output_raw import RawFileOutput
from iq_tool_tpu.modules.output_stdout import StdoutOutput
from iq_tool_tpu.modules.output_wav import WavLegacyOutput, WavOutput, WavRf64Output

INPUT_MODULES: dict[str, type[InputModule]] = {}
OUTPUT_MODULES: dict[str, type[OutputModule]] = {}


def register_input(cls: type[InputModule]) -> None:
    INPUT_MODULES[cls.name] = cls


def register_output(cls: type[OutputModule]) -> None:
    OUTPUT_MODULES[cls.name] = cls


for _c in (WavInput, RawFileInput, ToneInput):
    register_input(_c)
for _c in (RawFileOutput, WavOutput, WavRf64Output, WavLegacyOutput, StdoutOutput):
    register_output(_c)

# SDR/network sources register themselves lazily (hardware drivers may be
# absent on the host; the modules still expose their full option surface
# and fail with a clear error at initialize() if the driver is missing).
try:  # pragma: no cover - import side effects
    from iq_tool_tpu.modules.input_spyserver import SpyServerInput
    register_input(SpyServerInput)
except ImportError:
    pass
try:  # pragma: no cover
    from iq_tool_tpu.modules import input_sdr
    for _c in input_sdr.ALL:
        register_input(_c)
except ImportError:
    pass


def get_input(name: str) -> InputModule:
    try:
        return INPUT_MODULES[name]()
    except KeyError:
        raise ValueError(
            f"unknown input type '{name}'; available: "
            f"{', '.join(sorted(INPUT_MODULES))}") from None


def get_output(name: str) -> OutputModule:
    try:
        return OUTPUT_MODULES[name]()
    except KeyError:
        raise ValueError(
            f"unknown output type '{name}'; available: "
            f"{', '.join(sorted(OUTPUT_MODULES))}") from None
