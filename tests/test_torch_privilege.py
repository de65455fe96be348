"""Users and grants through the port's session against the JAX session.

Each script runs on a fresh pair of domains (``test_torch_dml.pair``:
the JAX domain with its scheduler and auto-analyze off, the port's on
the CPU).  A step is ``(user, sql)``: the statement runs in that user's
session over the pair's domain, root's or one opened for the user.
Outcomes are equal step by step: result names, rows and affected
counts, or the error's class (``PrivilegeError`` for a denied
statement).  Then the grant tables and a ``SET GLOBAL`` survive a
durable ``Domain`` reopened over its ``data_dir``, in both packages.
"""

import pytest

from test_torch_dml import _run, jax_domain, jax_session, pair
from tidb_tpu.session import Session as JSession
from tidb_tpu_torch.session import Domain, Session

SETUP = [
    ("root", "create table t (id bigint primary key, v bigint)"),
    ("root", "create table u (id bigint, w bigint)"),
    ("root", "insert into t values (1, 10), (2, 20)"),
    ("root", "insert into u values (1, 5)"),
]

SCRIPTS = {
    "create, grant and revoke by level": [
        ("root", "create user alice identified by 'pw'"),
        ("root", "show grants for alice"),
        ("alice", "select * from t"),                       # denied
        ("root", "grant select on test.t to alice"),
        ("alice", "select * from t order by id"),
        ("alice", "select * from u"),                       # denied
        ("alice", "insert into t values (3, 30)"),          # denied
        ("root", "grant insert on test.* to alice"),
        ("alice", "insert into t values (3, 30)"),
        ("alice", "insert into u values (9, 9)"),
        ("alice", "select count(*) from u"),                # denied
        ("root", "grant select on *.* to alice"),
        ("alice", "select count(*), sum(w) from u"),
        ("root", "show grants for alice"),
        ("root", "revoke select on *.* from alice"),
        ("alice", "select count(*) from u"),                # denied again
        ("root", "revoke all on test.* from alice"),
        ("alice", "insert into t values (4, 40)"),          # denied
        ("root", "show grants for alice"),
        ("alice", "show grants"),
    ],
    "account management": [
        ("root", "create user bob"),
        ("root", "create user bob"),                        # exists
        ("root", "create user if not exists bob"),
        ("bob", "create user carol"),                       # denied
        ("root", "grant create user on *.* to bob"),
        ("bob", "create user carol"),
        ("bob", "drop user carol"),
        ("root", "alter user bob identified by 'new'"),
        ("root", "drop user bob"),
        ("root", "drop user bob"),                          # unknown
        ("root", "drop user if exists bob"),
        ("root", "flush privileges"),
        ("root", "show grants for bob"),                    # unknown
    ],
    "reads inside writes and expressions": [
        ("root", "create user dave"),
        ("root", "grant insert on test.t to dave"),
        ("dave", "insert into t select id + 10, w from u"),   # reads u
        ("root", "grant select on test.u to dave"),
        ("dave", "insert into t select id + 10, w from u"),
        ("root", "grant update, delete on test.t to dave"),
        ("dave", "update t set v = 0 where id = 1"),          # WHERE reads
        ("dave", "update t set v = 7"),
        ("dave", "delete from t"),
        ("dave", "set @x = (select max(v) from t)"),          # denied
        ("root", "grant select on test.t to dave"),
        ("dave", "set @x = (select max(id) from t)"),
        ("dave", "select @x"),
        ("dave", "delete from t where id = 11"),
        ("dave", "select id, v from t order by id"),
        ("dave", "with c as (select id from u) select count(*) from c"),
    ],
    "grant levels, USE and the process list": [
        ("root", "create database app"),
        ("root", "create user erin"),
        ("erin", "use app"),                                # no access
        ("root", "grant select on app.* to erin"),
        ("erin", "use app"),
        ("root", "use app"),
        ("root", "create table w (a bigint)"),
        ("root", "grant insert on w to erin"),               # app.w
        ("root", "show grants for erin"),
        ("erin", "show processlist"),
        ("erin", "show grants for root"),                    # needs SUPER
        ("erin", "kill query 1"),                            # not owner
        ("root", "kill query 99999"),                        # unknown id
        ("erin", "admin check table w"),                     # needs SUPER
        ("erin", "create table v2 (a bigint)"),              # no CREATE
        ("root", "grant process on *.* to erin"),
        ("erin", "show processlist"),
        ("erin", "insert into w values (1)"),
        ("erin", "select count(*) from w"),
        ("erin", "select count(*) from information_schema.tables"),
    ],
}


def _sessions(js, ps):
    """user -> (JAX session, port session), opened on demand over the
    pair's domains; root's are the pair's own."""
    out = {"root": (js, ps)}

    def get(user):
        if user not in out:
            out[user] = (JSession(js.domain, user=user),
                         Session(ps.domain, user=user))
        return out[user]
    return get


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_grant_script_equals_the_jax_session(name):
    js, ps = pair()
    get = _sessions(js, ps)
    for user, sql in SETUP + SCRIPTS[name]:
        j, p = get(user)
        want, got = _run(j, sql), _run(p, sql)
        if sql == "show processlist":
            # connection ids and the set of live sessions are each
            # domain's own: compare the shape and the caller's own row
            assert got[1] == want[1]
            assert [r[2:] for r in got[2] if r[2] == "Query"] == \
                [r[2:] for r in want[2] if r[2] == "Query"]
            continue
        assert got == want, (name, user, sql, got, want)


def test_denied_statement_names_the_privilege():
    js, ps = pair()
    for s in (js, ps):
        s.execute("create table t (a bigint)")
        s.execute("create user frank")
    msgs = []
    for cls, dom in ((JSession, js.domain), (Session, ps.domain)):
        with pytest.raises(PermissionError) as e:
            cls(dom, user="frank").execute("select a from t")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == (
        "SELECT command denied to user 'frank' for table 'test.t'")


def test_wire_auth_checks_the_grant_tables():
    """``authenticate`` and ``authenticate_cleartext`` agree with the JAX
    manager on a user with a password."""
    from tidb_tpu.utils.auth import scramble_password as j_scramble
    from tidb_tpu_torch.utils.auth import scramble_password
    js, ps = pair()
    for s in (js, ps):
        s.execute("create user gina identified by 'secret'")
    salt = bytes(range(1, 21))
    assert scramble_password("secret", salt) == j_scramble("secret", salt)
    for pwd in ("secret", "wrong", ""):
        auth = scramble_password(pwd, salt)
        assert ps.domain.privileges.authenticate("gina", auth, salt) == \
            js.domain.privileges.authenticate("gina", auth, salt)
        assert ps.domain.privileges.authenticate_cleartext("gina", pwd) == \
            js.domain.privileges.authenticate_cleartext("gina", pwd)
    assert ps.domain.privileges.snapshot() == js.domain.privileges.snapshot()


def test_grants_and_global_sysvars_survive_a_reopen(tmp_path):
    """Users, grants and a ``SET GLOBAL`` persist through the watch
    plane's keys in a durable store and reload in a new ``Domain`` over
    the same directory, as in the JAX package."""
    outs = []
    for tag, mk_dom, mk_sess in (
            ("jax", lambda d: jax_domain(data_dir=d), jax_session),
            ("port", lambda d: Domain("cpu", data_dir=d), Session)):
        d = str(tmp_path / tag)
        dom = mk_dom(d)
        s = mk_sess(dom)
        s.execute("create table t (a bigint)")
        s.execute("create user hank identified by 'pw'")
        s.execute("grant select, insert on test.t to hank")
        s.execute("set global tidb_mem_quota_query = 123456789")
        dom.close()
        dom2 = mk_dom(d)
        r = mk_sess(dom2)
        h = (JSession if tag == "jax" else Session)(dom2, user="hank")
        outs.append([
            _run(r, "show grants for hank"),
            _run(h, "insert into t values (1)"),
            _run(h, "select a from t"),
            _run(h, "delete from t"),
            dom2.sysvars["tidb_mem_quota_query"],
            dom2.privileges.snapshot(),
        ])
        dom2.close()
    assert outs[1] == outs[0]
    assert outs[1][4] == 123456789
    assert outs[1][3] == ("error", "PrivilegeError")
