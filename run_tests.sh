#!/bin/sh
# Run the test suite on a virtual 8-device CPU mesh.
#
#   ./run_tests.sh              fast tier (-m 'not slow', pyproject addopts),
#                               parallel via pytest-xdist (-n auto)
#   ./run_tests.sh --full       EVERYTHING incl. the slow external-parity
#                               oracles and multichip dryrun (-m '') -- the
#                               pre-merge gate (a green fast run must not be
#                               mistaken for the oracle tier)
#   ./run_tests.sh -n 0 ...     opt out of xdist (single process)
#
# Tests marked `gpu` skip here; `python chip_smoke.py` runs the same
# checks on a GPU.

want_xdist=1
want_full=0
for a in "$@"; do
    case "$a" in
        -n|-n*) want_xdist=0 ;;      # caller picked their own worker count
        --full) want_full=1 ;;
    esac
done

# Rebuild "$@" without --full, prepending our defaults.
set -- --rtw-sentinel "$@"
for a in "$@"; do
    [ "$a" = "--rtw-sentinel" ] && { shift; continue; }
    [ "$a" = "--full" ] && { shift; continue; }
    set -- "$@" "$a"
    shift
done
[ "$want_full" = 1 ] && set -- -m "" "$@"
[ "$want_xdist" = 1 ] && set -- -n auto "$@"

exec env JAX_PLATFORMS=cpu python -m pytest "$@"
