"""INI options loader — the reference's config vocabulary.

Role of the reference's inih-based per-module option handlers
(`Utilities/ini.h:21-41`; every module parses its own `[section]` of one
`options.input`): here one loader reads the whole file into a dict of
sections and typed getters; modules pull their sections by the SAME names
(`[initial_mesh] [mesh_parameters] [amr] [flux] [geometry] [quadrature]
[multigrid] [mg_smoother_cheby] ...` — see
`Problems/ConstantDensityStar/options.input` for the full worked example).

Reference quirks handled: `;` comments, trailing semicolons on values,
and required-key checking (`D4EST_CHECK_INPUT` aborts on missing keys).

Port of `disco4est_tpu/util/config.py` (plain Python, copied unchanged).
"""

from __future__ import annotations

import configparser


class Options:
    def __init__(self, sections: dict):
        self._sections = sections

    @staticmethod
    def load(path_or_text: str) -> "Options":
        if "\n" in path_or_text or "=" in path_or_text:
            text = path_or_text
        else:
            with open(path_or_text) as f:
                text = f.read()
        cp = configparser.ConfigParser(
            inline_comment_prefixes=(";", "#"), strict=False
        )
        cp.read_string(text)
        sections = {
            s: {k: v.strip().rstrip(";").strip() for k, v in cp[s].items()}
            for s in cp.sections()
        }
        return Options(sections)

    def has(self, section: str, key: str | None = None) -> bool:
        if key is None:
            return section in self._sections
        return section in self._sections and key in self._sections[section]

    def get(self, section, key, default=None, required=False, cast=str):
        if not self.has(section, key):
            if required:
                raise KeyError(
                    f"missing required option [{section}] {key} "
                    "(D4EST_CHECK_INPUT)"
                )
            return default
        v = self._sections[section][key]
        if cast is bool:
            return v.lower() in ("1", "true", "yes")
        return cast(v)

    def get_int(self, section, key, default=None, required=False):
        return self.get(section, key, default, required, int)

    def get_float(self, section, key, default=None, required=False):
        return self.get(section, key, default, required, float)

    def section(self, name) -> dict:
        return dict(self._sections.get(name, {}))
