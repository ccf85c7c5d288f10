"""Worker geolocation for the public dashboard map.

Capability parity with the reference
(ref bioengine/utils/geo_location.py:19-157): a fallback chain of IP
geolocation providers plus a Nominatim centroid lookup, all
failure-tolerant — a worker with zero egress (the common TPU-pod
situation) gets all-None coordinates and keeps running. Providers can
be disabled entirely with ``BIOENGINE_DISABLE_GEOLOCATION=1``.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional

import httpx

_TIMEOUT = 10.0

_EMPTY: Dict[str, Optional[str]] = {
    "region": None,
    "country_name": None,
    "country_code": None,
    "latitude": None,
    "longitude": None,
    "timezone": None,
}


async def _get(url: str, params: Optional[dict] = None) -> httpx.Response:
    async with httpx.AsyncClient(timeout=_TIMEOUT) as client:
        resp = await client.get(
            url, params=params, headers={"User-Agent": "bioengine-tpu"}
        )
        resp.raise_for_status()
        return resp


async def _fetch_from_ipwhois() -> Dict:
    data = (await _get("https://ipwho.is/")).json()
    if not data.get("success"):
        raise ValueError(f"ipwho.is error: {data.get('message')}")
    return {
        "region": data.get("region"),
        "country_name": data.get("country"),
        "country_code": data.get("country_code"),
        "latitude": data.get("latitude"),
        "longitude": data.get("longitude"),
        "timezone": (data.get("timezone") or {}).get("id"),
    }


async def _fetch_from_ipapi_com() -> Dict:
    data = (await _get("http://ip-api.com/json/")).json()
    if data.get("status") != "success":
        raise ValueError(f"ip-api.com error: {data.get('message')}")
    return {
        "region": data.get("regionName"),
        "country_name": data.get("country"),
        "country_code": data.get("countryCode"),
        "latitude": data.get("lat"),
        "longitude": data.get("lon"),
        "timezone": data.get("timezone"),
    }


async def _fetch_from_ipapi_co() -> Dict:
    data = (await _get("https://ipapi.co/json/")).json()
    if data.get("error"):
        raise ValueError(f"ipapi.co error: {data.get('reason')}")
    return {
        "region": data.get("region"),
        "country_name": data.get("country_name"),
        "country_code": data.get("country_code") or data.get("country"),
        "latitude": data.get("latitude"),
        "longitude": data.get("longitude"),
        "timezone": data.get("timezone"),
    }


PROVIDERS: list[tuple[str, Callable]] = [
    ("ipwho.is", _fetch_from_ipwhois),
    ("ip-api.com", _fetch_from_ipapi_com),
    ("ipapi.co", _fetch_from_ipapi_co),
]


async def fetch_geolocation(
    logger: Optional[logging.Logger] = None,
) -> Dict[str, Optional[str]]:
    """Try each provider in order; all-None when every provider fails
    or geolocation is disabled."""
    if logger is None:
        logger = logging.getLogger(__name__)
    if os.environ.get("BIOENGINE_DISABLE_GEOLOCATION"):
        return dict(_EMPTY)
    for name, fetch in PROVIDERS:
        try:
            geo = await fetch()
            # providers occasionally return names without coordinates —
            # fall back to the Nominatim centroid of the region/country
            if geo.get("latitude") is None and geo.get("country_name"):
                geo.update(
                    await fetch_centroid_coordinates(
                        geo["country_name"], geo.get("region"), logger
                    )
                )
            logger.info(
                "geolocation via %s: %s, %s (tz %s)",
                name, geo["region"], geo["country_name"], geo["timezone"],
            )
            return geo
        except Exception as e:
            logger.warning("geolocation provider '%s' failed: %s", name, e)
    logger.warning("all geolocation providers failed")
    return dict(_EMPTY)


async def fetch_centroid_coordinates(
    country: str,
    region: Optional[str] = None,
    logger: Optional[logging.Logger] = None,
) -> Dict[str, Optional[float]]:
    """Nominatim centroid for a country/region name
    (ref geo_location.py:19-64)."""
    if logger is None:
        logger = logging.getLogger(__name__)
    query = ", ".join(p for p in (region, country) if p)
    try:
        data = (
            await _get(
                "https://nominatim.openstreetmap.org/search",
                params={"q": query, "format": "json", "limit": 1},
            )
        ).json()
        if data:
            return {
                "latitude": float(data[0]["lat"]),
                "longitude": float(data[0]["lon"]),
            }
    except Exception as e:
        logger.warning("centroid lookup for '%s' failed: %s", query, e)
    return {"latitude": None, "longitude": None}
