"""Global settings (counterpart of rtsdm_tpu/core/settings.py; reference
Utils/Settings.h:297-324): options from a dict or a JSON/TOML file, looked
up by 'a:b:c' paths, and wildcard-filtered attributes per subject."""
from __future__ import annotations

import fnmatch
import json


class Settings:
    def __init__(self):
        self._options: dict = {}
        self._attribute_filters: list[tuple[str, dict]] = []

    def add_options(self, source):
        if isinstance(source, str):
            if source.endswith(".toml"):
                import tomllib
                with open(source, "rb") as f:
                    data = tomllib.load(f)
            else:
                with open(source) as f:
                    data = json.load(f)
        else:
            data = dict(source)
        self._options.update(data)

    def get_option(self, name, default=None):
        cur = self._options
        for part in name.split(":"):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur

    def add_filtered_attributes(self, pattern: str, attributes: dict):
        """Attributes for every subject matching `pattern`, e.g.
        ("Arcade*", {"rtao.radius": 0.5})."""
        self._attribute_filters.append((pattern, dict(attributes)))

    def get_attribute(self, subject: str, name: str, default=None):
        value = default
        for pattern, attrs in self._attribute_filters:
            if fnmatch.fnmatch(subject, pattern) and name in attrs:
                value = attrs[name]
        return value

    def clear_filtered_attributes(self):
        self._attribute_filters.clear()
