"""INI-based DSP workspace configuration.

Reference semantics: configRoutines/_core.py
(DirectSingleConfig :74, SourceSectionProxy :109, SignalSectionProxy :150,
ProcessingSectionProxy :202, WorkspaceSectionProxy :228, DSPConfig :234,
SingleProcessDSPConfig :415).

Sections are typed by name prefix: 'src_' sources (capture parameters),
'sig_' signals (modulation parameters), 'pro_' processing (links a source
and a signal, adds filter/detection parameters), and everything else is a
workspace aggregating processing sections.

A copy of the JAX package's ``pydsproutines_tpu/io/config.py``, which does
not import JAX: the port keeps its own because importing any module of that
package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import os
from configparser import ConfigParser, SectionProxy


class SourceSection(SectionProxy):
    """Capture source description (reference SourceSectionProxy)."""

    def __repr__(self):
        return f"<SourceSection: {self._name}>"

    @property
    def srcdir(self):
        return self.get("srcdir")

    @property
    def fs(self):
        return self.getfloat("fs")

    @property
    def fc(self):
        return self.getfloat("fc")

    @property
    def conj_samples(self):
        return self.getboolean("conjSamples")

    @property
    def header_bytes(self):
        return self.getint("headerBytes")

    @property
    def dtype(self):
        return self.get("dtype")

    @property
    def lonlatalt(self):
        s = self.get("lonlatalt")
        if s is None:
            return None
        lon, lat, alt = (float(v) for v in s.split(","))
        return lon, lat, alt


class SignalSection(SectionProxy):
    """Signal description (reference SignalSectionProxy)."""

    def __repr__(self):
        return f"<SignalSection: {self._name}>"

    @property
    def target_fc(self):
        return self.getfloat("target_fc")

    @property
    def baud(self):
        return self.getfloat("baud")

    @property
    def num_period_bits(self):
        return self.getint("numPeriodBits")

    @property
    def num_burst_bits(self):
        return self.getint("numBurstBits")

    @property
    def num_guard_bits(self):
        return self.getint("numGuardBits")

    @property
    def num_bursts(self):
        return self.getint("numBursts")

    @property
    def has_channels(self):
        return self.getint("numChannels") is not None

    @property
    def num_channels(self):
        return self.getint("numChannels")

    @property
    def channel_spacing_hz(self):
        return self.getfloat("channelSpacingHz")


class ProcessingSection(SectionProxy):
    """Processing description linking a source and a signal (reference
    ProcessingSectionProxy)."""

    def __repr__(self):
        return f"<ProcessingSection: {self._name}>"

    @property
    def src(self):
        return self.parser.get_src(self.get("src"))

    @property
    def sig(self):
        return self.parser.get_sig(self.get("sig"))

    @property
    def num_taps(self):
        return self.getint("numTaps")

    @property
    def target_osr(self):
        return self.getint("target_osr")

    @property
    def threshold(self):
        return self.getfloat("threshold")


class WorkspaceSection(SectionProxy):
    def __repr__(self):
        return f"<WorkspaceSection: {self._name}>"


class DSPConfig(ConfigParser):
    """Typed DSP workspace config (reference DSPConfig)."""

    def __init__(self, filename: str, *args, allow_no_value=True, **kwargs):
        super().__init__(*args, allow_no_value=allow_no_value, **kwargs)
        self.optionxform = str  # preserve case
        if not os.path.exists(filename):
            raise FileNotFoundError(filename)
        self.read(filename)
        self.current_section = None
        self._recast_sections()

    @classmethod
    def new(cls, filename: str, *args, **kwargs):
        open(filename, "w").close()
        return cls(filename, *args, **kwargs)

    # section typing -----------------------------------------------------
    @staticmethod
    def _is_source(key: str) -> bool:
        return key.startswith("src_")

    @staticmethod
    def _is_signal(key: str) -> bool:
        return key.startswith("sig_")

    @staticmethod
    def _is_processing(key: str) -> bool:
        return key.startswith("pro_")

    @classmethod
    def _is_workspace(cls, key: str) -> bool:
        return not (cls._is_source(key) or cls._is_signal(key)
                    or cls._is_processing(key) or key == "DEFAULT")

    def _recast_sections(self):
        for key in list(self._proxies):
            proxy = self._proxies[key]
            if self._is_source(key):
                cls = SourceSection
            elif self._is_signal(key):
                cls = SignalSection
            elif self._is_processing(key):
                cls = ProcessingSection
            else:
                cls = WorkspaceSection
            self._proxies[key] = cls(proxy._parser, proxy._name)

    # collections ---------------------------------------------------------
    @property
    def all_sources(self):
        return {k[4:]: v for k, v in self._proxies.items()
                if self._is_source(k)}

    @property
    def all_signals(self):
        return {k[4:]: v for k, v in self._proxies.items()
                if self._is_signal(k)}

    @property
    def all_processes(self):
        return {k[4:]: v for k, v in self._proxies.items()
                if self._is_processing(k)}

    @property
    def all_workspaces(self):
        return {k: v for k, v in self._proxies.items()
                if self._is_workspace(k)}

    # lookups --------------------------------------------------------------
    def get_src(self, name: str) -> SourceSection:
        return self._proxies["src_" + name]

    def get_sig(self, name: str) -> SignalSection:
        return self._proxies["sig_" + name]

    def get_process(self, name: str) -> ProcessingSection:
        return self._proxies["pro_" + name]

    # workspace flow --------------------------------------------------------
    def load_section(self, section: str):
        self.current_section = self[section]

    @property
    def processes(self):
        """Processing sections referenced by the loaded workspace."""
        if self.current_section is None:
            raise ValueError("load_section() a workspace first")
        return {k[4:]: self._proxies[k]
                for k in self.current_section.keys()
                if self._is_processing(k)}

    # modifiers --------------------------------------------------------------
    def add_source(self, name: str):
        self.add_section("src_" + name)
        self._recast_sections()

    def add_signal(self, name: str):
        self.add_section("sig_" + name)
        self._recast_sections()

    def add_process(self, name: str):
        self.add_section("pro_" + name)
        self._recast_sections()

    def add_workspace(self, name: str):
        self.add_section(name)
        self._recast_sections()


class SingleProcessDSPConfig(DSPConfig):
    """Workspaces with exactly one process: direct src/sig access
    (reference SingleProcessDSPConfig, configRoutines/_core.py:415)."""

    @property
    def process(self):
        return next(iter(self.processes.values()))

    @property
    def src(self):
        return self.process.src

    @property
    def sig(self):
        return self.process.sig
