# Perl binding for the TPU-native Bloom filter framework.
#
# Mirrors the surface the reference exports through SWIG
# (/root/reference/swig/BloomFilter.i:17-39): package
# BloomFilter::BloomFilter wraps KmerBloomFilter with
#   new(size, hashNum, kmerSize) | new(path)
#   insert($kmer | \@precomputed)      contains($kmer | \@precomputed)
#   storeFilter($path)                 getPop / getHashNum /
#   insertAndCheck($kmer)              getKmerSize / getFilterSize
# plus BloomFilter::insertSeq($bloom, $seq, $numHashes, $k)
# (/root/reference/BloomFilterUtil.h:9-17).
#
# Implementation: a persistent Python worker (swig/bridge_server.py)
# drives the framework; this module speaks line-delimited JSON to it over
# a pipe pair. Files written by storeFilter are byte-identical to the
# reference's .bf format, so they interchange with the C++/SWIG stack.

package BloomFilter;

use strict;
use warnings;
use IPC::Open2;
use JSON::PP;
use FindBin;

our $VERSION = '1.0';

my ($_pid, $_in, $_out);
my $_json = JSON::PP->new->canonical;
my $_next = 0;

sub _bridge {
    return if defined $_pid;
    my $server = "$FindBin::Bin/bridge_server.py";
    die "bridge_server.py not found next to BloomFilter.pm"
        unless -e $server;
    my $py = $ENV{BTL_BRIDGE_PYTHON} // 'python3';
    $_pid = open2($_out, $_in, $py, $server)
        or die "cannot start python bridge";
}

sub _call {
    my ($op, @args) = @_;
    _bridge();
    my $id = ++$_next;
    print {$_in} $_json->encode({id => $id, op => $op, args => \@args}),
        "\n";
    $_in->flush;
    my $line = readline($_out);
    die "python bridge died" unless defined $line;
    my $reply = $_json->decode($line);
    die "bridge error: $reply->{error}" unless $reply->{ok};
    return $reply->{result};
}

# BloomFilterUtil.h:9-17 (free function, as SWIG exports it)
sub insertSeq {
    my ($bloom, $seq, $numHashes, $k) = @_;
    _call('insertSeq', $bloom->{fid}, $seq, $numHashes // 0, $k // 0);
    return;
}

END {
    if (defined $_pid) {
        close $_in if defined $_in;
        waitpid $_pid, 0;
    }
}

package BloomFilter::BloomFilter;

use strict;
use warnings;

sub new {
    my ($class, @args) = @_;
    my $fid = BloomFilter::_call('new', @args);
    return bless {fid => $fid}, $class;
}

sub insert {
    my ($self, $arg) = @_;
    BloomFilter::_call('insert', $self->{fid}, $arg);
    return;
}

sub insertAndCheck {
    my ($self, $arg) = @_;
    return BloomFilter::_call('insertAndCheck', $self->{fid}, $arg);
}

sub contains {
    my ($self, $arg) = @_;
    return BloomFilter::_call('contains', $self->{fid}, $arg);
}

sub storeFilter {
    my ($self, $path) = @_;
    BloomFilter::_call('storeFilter', $self->{fid}, $path);
    return;
}

sub getPop        { BloomFilter::_call('getPop',        $_[0]->{fid}) }
sub getFPR        { BloomFilter::_call('getFPR',        $_[0]->{fid}) }
sub getHashNum    { BloomFilter::_call('getHashNum',    $_[0]->{fid}) }
sub getKmerSize   { BloomFilter::_call('getKmerSize',   $_[0]->{fid}) }
sub getFilterSize { BloomFilter::_call('getFilterSize', $_[0]->{fid}) }
sub sizeInBytes   { BloomFilter::_call('sizeInBytes',   $_[0]->{fid}) }

sub DESTROY {
    my ($self) = @_;
    eval { BloomFilter::_call('free', $self->{fid}) };
    return;
}

1;
