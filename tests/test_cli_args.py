"""`--distributed HOST:PORT,N,I[,CARD]`: which local GPU a process drives."""
import pytest

from mitsuba_tpu import cli


@pytest.mark.parametrize("spec, environ, card", [
    ("h:1,8,5", {}, None),                  # one process per host
    ("h:1,8,5", {"LOCAL_RANK": "1"}, 1),    # launcher's local rank
    ("h:1,8,5,3", {"LOCAL_RANK": "1"}, 3),  # explicit card wins
    ("h:1,8,5,0", {}, 0),
])
def test_card_choice(spec, environ, card):
    """The card never follows the global process id: on a second host
    process 5 of 8 drives a local card, not card 5."""
    assert cli._parse_distributed(spec, environ) == ("h:1", 8, 5, card)


@pytest.mark.parametrize("spec", ["h:1,8", "h:1,8,5,3,2", "h:1,8,5,-1",
                                  "h:1,x,5"])
def test_bad_spec_exits(spec):
    with pytest.raises(SystemExit):
        cli._parse_distributed(spec, {})
