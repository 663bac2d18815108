"""Sensor tag representation and normalization.

Copy of ``gordo_tpu/dataset/sensor_tag.py`` (the port imports nothing of
the JAX package).

Reference equivalent: ``gordo_components/dataset/sensor_tag.py`` —
``SensorTag(name, asset)`` plus ``normalize_sensor_tags`` accepting the
config-surface spellings (plain strings, ``[name, asset]`` lists,
``{name:, asset:}`` dicts, SensorTag) and inferring assets when possible.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Union


class SensorTag(NamedTuple):
    name: str
    asset: Optional[str] = None

    def to_json(self) -> dict:
        return {"name": self.name, "asset": self.asset}


TagLike = Union[str, dict, list, tuple, SensorTag]


class SensorTagNormalizationError(ValueError):
    pass


def _normalize_one(tag: TagLike, asset: Optional[str]) -> SensorTag:
    if isinstance(tag, SensorTag):
        return tag if tag.asset or not asset else SensorTag(tag.name, asset)
    if isinstance(tag, str):
        return SensorTag(tag, asset)
    if isinstance(tag, dict):
        try:
            return SensorTag(tag["name"], tag.get("asset", asset))
        except KeyError:
            raise SensorTagNormalizationError(
                f"Sensor tag dict {tag!r} requires a 'name' key"
            )
    if isinstance(tag, (list, tuple)):
        if len(tag) == 2:
            return SensorTag(str(tag[0]), tag[1])
        if len(tag) == 1:
            return SensorTag(str(tag[0]), asset)
        raise SensorTagNormalizationError(
            f"Sensor tag list {tag!r} must be [name] or [name, asset]"
        )
    raise SensorTagNormalizationError(f"Cannot normalize sensor tag {tag!r}")


def normalize_sensor_tags(
    tags: List[TagLike], asset: Optional[str] = None
) -> List[SensorTag]:
    """Normalize every config spelling of a tag list to ``SensorTag``s."""
    return [_normalize_one(tag, asset) for tag in tags]


def to_list_of_strings(tags: List[SensorTag]) -> List[str]:
    return [tag.name for tag in tags]
